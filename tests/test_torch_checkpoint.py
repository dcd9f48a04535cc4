"""The port's pure-Python msgpack reader against flax's own decoder.

``wavernn_tpu_torch.utils.checkpoints.load_pytree`` must read the
checkpoints the JAX package writes, leaf for leaf and bit for bit, without
flax or the ``msgpack`` package (neither exists where the port runs)."""

from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
from flax import serialization

from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
CHECKPOINTS = [
    REPO / "bench_assets" / "wavernn_mol_golden.msgpack",
    REPO / "tests" / "golden" / "tiny_wavernn_raw.msgpack",
    REPO / "tests" / "golden" / "tiny_tacotron.msgpack",
]


@pytest.mark.parametrize("path", CHECKPOINTS, ids=lambda p: p.name)
def test_load_pytree_equals_flax(path):
    """Exact equality: same tree paths, dtypes, shapes and bytes."""
    got = load_pytree(path)
    want = serialization.msgpack_restore(path.read_bytes())
    lg = jax.tree_util.tree_leaves_with_path(got)
    lw = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (p, a), (_, b) in zip(lg, lw):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p
    # the step counter is a 0-d array in ext type 1, not a msgpack int
    assert isinstance(got["step"], np.ndarray) and got["step"].ndim == 0


def test_golden_layout():
    """batch_stats sits beside params, not inside it."""
    tree = load_pytree(CHECKPOINTS[0])
    assert set(tree) == {"params", "batch_stats", "step"}
    assert int(tree["step"]) == 3000
    assert tree["params"]["fc3"]["kernel"].shape == (512, 30)
    assert tree["batch_stats"]["upsample"]["resnet"]["bn"]["mean"].dtype \
        == np.float32


def test_plain_msgpack_values(tmp_path):
    """Every plain msgpack type flax can emit decodes as msgpack does:
    fix/8/16/32/64-bit ints of both signs, f32/f64, nil, bools, short and
    long strings, bin, nested maps and arrays."""
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 40,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
        "floats": [0.5, -1.25e-30, 1e300],
        "misc": [None, True, False, "x" * 40, "y" * 300, b"\x00\x01" * 200],
        "nested": {"a": {"b": {"c": []}}, "m": {str(i): i for i in range(20)}},
        "big": list(range(70000)),
    }
    p = tmp_path / "plain.msgpack"
    p.write_bytes(msgpack.packb(obj, use_bin_type=True))
    got = load_pytree(p)
    assert got == msgpack.unpackb(p.read_bytes(), raw=False)
    # single-precision floats round-trip as Python floats of their value
    p32 = tmp_path / "f32.msgpack"
    p32.write_bytes(msgpack.packb(1.5, use_single_float=True))
    assert load_pytree(p32) == 1.5


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8", "int32",
                                   "int64", "uint8", "bool", "float64"])
def test_ndarray_ext_roundtrip(tmp_path, dtype):
    """Ext type 1 (ndarray) and ext type 3 (numpy scalar) as flax writes
    them, for every dtype a checkpoint may hold."""
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((3, 5, 2)) * 50).astype(dtype)
    tree = {"a": arr, "s": arr.reshape(-1)[0], "z": np.zeros((0, 4), dtype)}
    p = tmp_path / "arr.msgpack"
    p.write_bytes(serialization.msgpack_serialize(tree))
    got = load_pytree(p)
    want = serialization.msgpack_restore(p.read_bytes())
    for k in tree:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_chunked_array_refused(tmp_path):
    """The chunked form flax uses for leaves above 1 GiB is refused."""
    blob = {"w": {"__msgpack_chunked_array__": True, "shape": [2],
                  "chunks": {}}}
    p = tmp_path / "chunked.msgpack"
    p.write_bytes(msgpack.packb(blob, use_bin_type=True))
    with pytest.raises(ValueError, match="chunked"):
        load_pytree(p)


def test_truncated_and_trailing_bytes_raise(tmp_path):
    data = CHECKPOINTS[1].read_bytes()
    p = tmp_path / "cut.msgpack"
    p.write_bytes(data[:-10])
    with pytest.raises(ValueError, match="truncated"):
        load_pytree(p)
    p.write_bytes(data + b"\x00")
    with pytest.raises(ValueError, match="trailing"):
        load_pytree(p)
