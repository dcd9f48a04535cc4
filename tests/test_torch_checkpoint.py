"""The port's pure-Python msgpack reader and writer against flax, and its
training checkpoint pairs against the JAX package's.

``wavernn_tpu_torch.utils.checkpoints.load_pytree`` must read the
checkpoints the JAX package writes, leaf for leaf and bit for bit, and
``save_pytree`` must write what ``flax.serialization.msgpack_serialize``
writes, byte for byte, without flax or the ``msgpack`` package (neither
exists where the port runs).  A training pair (weights + optimizer) written
by either package resumes in the other; the next step after a resume is
held to ``tests/test_torch_training.py``'s tolerances."""

from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
from flax import serialization

from wavernn_tpu.paths import Paths as JaxPaths
from wavernn_tpu.training.state import make_optimizer as jax_optimizer
from wavernn_tpu.training.state import new_train_state as jax_state
from wavernn_tpu.training.wavernn import make_train_step as jax_train_step
from wavernn_tpu.models.wavernn import WaveRNN as JaxWaveRNN
from wavernn_tpu.utils import checkpoints as jax_ckpt
from wavernn_tpu_torch.models.wavernn import to_jax_tree, to_jax_variables
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.training.state import (
    make_optimizer, new_train_state,
)
from wavernn_tpu_torch.training.wavernn import make_train_step
from wavernn_tpu_torch.utils.checkpoints import (
    load_pytree, pack_pytree, restore_checkpoint, save_checkpoint,
    save_pytree,
)
from tests.test_training import make_batch
from tests.test_torch_training import setup
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


# -- the writer and the training pairs ---------------------------------------

LR, CLIP = 1e-3, 0.1


def port_trained(mode="RAW", steps=1):
    """A port model, optimizer state and step after ``steps`` train steps,
    with the JAX variables it started from."""
    jcfg, v, model, _ = setup(mode)
    opt = make_optimizer(LR, CLIP)
    state = new_train_state(model, opt)
    step = make_train_step(opt, mode)
    rng = np.random.default_rng(11)
    for _ in range(steps):
        step(state, *make_batch(jcfg, B=4, rng=rng))
    return jcfg, v, state


def both_paths(base):
    return (Paths(base / "data", "voc", "tts", base=base),
            JaxPaths(base / "data", "voc", "tts", base=base))


def test_save_pytree_bytes_equal_flax(tmp_path):
    """A weights blob of a trained port model, and a tree of every plain
    type: the port's bytes are flax's."""
    _, _, state = port_trained()
    v = to_jax_variables(state.model)
    blob = {"params": v["params"], "batch_stats": v["batch_stats"],
            "step": np.asarray(state.step, np.int32)}
    want = serialization.msgpack_serialize(serialization.to_state_dict(blob))
    assert pack_pytree(blob) == want
    assert pack_pytree(state.weights_tree()) == want
    save_pytree(blob, tmp_path / "w.msgpack")
    assert (tmp_path / "w.msgpack").read_bytes() == want
    rng = np.random.default_rng(0)
    tree = {"b": {"x": rng.standard_normal((3, 70)).astype(np.float32)},
            "a": {}, "ints": [0, 127, 128, 65536, 2 ** 40, -1, -33, -129,
                              -32769, -2 ** 31 - 1],
            "f": [0.5, 1e300], "s": "x" * 40, "long": "y" * 300,
            "n": None, "t": True, "g": np.float32(2.5),
            "h": np.float64(3.0), "bool": np.bool_(True),
            "many": {str(i): np.zeros(i, np.int8) for i in range(20)},
            "bin": b"\x00" * 70000}
    assert pack_pytree(tree) == serialization.msgpack_serialize(tree)


def test_jax_restores_a_port_pair(tmp_path):
    jcfg, v, state = port_trained(steps=2)
    paths, jpaths = both_paths(tmp_path)
    save_checkpoint("voc", paths, state, name="snap", is_silent=True)
    opt_j = jax_optimizer(LR, CLIP)
    template = jax_state(v["params"], v["batch_stats"], opt_j)
    for name in (None, "snap"):
        got = jax_ckpt.restore_checkpoint("voc", jpaths, template, name=name)
        assert int(got.step) == 2
        want = to_jax_variables(state.model)
        for tree in ("params", "batch_stats"):
            for (p, a), (_, b) in zip(
                    jax.tree_util.tree_leaves_with_path(getattr(got, tree)),
                    jax.tree_util.tree_leaves_with_path(want[tree])):
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=p)
        inject = got.opt_state[1]
        assert int(inject.count) == 2
        assert int(inject.inner_state[0].count) == 2
        assert float(inject.hyperparams["learning_rate"]) == \
            float(np.float32(LR))
        for moment in ("mu", "nu"):
            ours = getattr(state.opt_state, moment)
            mine = jax.tree_util.tree_leaves(
                to_jax_tree(ours, state.model.cfg))
            theirs = jax.tree_util.tree_leaves(
                getattr(inject.inner_state[0], moment))
            assert len(mine) == len(theirs)
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(np.asarray(b), a)


def test_port_resumes_a_jax_pair_and_rewrites_it(tmp_path):
    """JAX trains a step and saves; the port restores the pair, writes it
    back byte for byte, and its next step matches JAX's next step."""
    jcfg, v, model, _ = setup("RAW")
    opt_j = jax_optimizer(LR, CLIP)
    state_j = jax_state(v["params"], v["batch_stats"], opt_j)
    step_j = jax_train_step(JaxWaveRNN(jcfg), opt_j, "RAW", donate=False)
    rng = np.random.default_rng(5)
    state_j, _, _ = step_j(state_j, *map(jnp.asarray,
                                         make_batch(jcfg, B=4, rng=rng)))
    paths, jpaths = both_paths(tmp_path / "a")
    jax_ckpt.save_checkpoint("voc", jpaths, state_j, is_silent=True)

    opt = make_optimizer(LR, CLIP)
    state = restore_checkpoint("voc", paths, new_train_state(model, opt))
    assert state.step == 1 and state.opt_state.count == 1
    paths2, _ = both_paths(tmp_path / "b")
    save_checkpoint("voc", paths2, state, is_silent=True)
    for a, b in ((paths.voc_latest_weights, paths2.voc_latest_weights),
                 (paths.voc_latest_optim, paths2.voc_latest_optim)):
        assert a.read_bytes() == b.read_bytes(), a.name

    batch = make_batch(jcfg, B=4, rng=rng)
    state_j, loss_j, gn_j = step_j(state_j, *map(jnp.asarray, batch))
    state, loss, gn = make_train_step(opt, "RAW")(state, *batch)
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert abs(float(gn) - float(gn_j)) <= 1e-5 * float(gn_j)
    got = to_jax_variables(state.model)["params"]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(state_j.params)):
        d = np.abs(a - np.asarray(b))
        assert np.mean(d <= 1e-6) >= 0.999 and d.max() <= 6 * LR + 1e-6


def test_pair_integrity_and_create_if_missing(tmp_path):
    _, _, state = port_trained(steps=1)
    paths, _ = both_paths(tmp_path)
    with pytest.raises(FileNotFoundError, match="could not be found"):
        restore_checkpoint("voc", paths, state)
    restore_checkpoint("voc", paths, state, create_if_missing=True)
    assert paths.voc_latest_weights.exists() and \
        paths.voc_latest_optim.exists()
    assert int(load_pytree(paths.voc_latest_weights)["step"]) == 1
    state.step = 7
    save_checkpoint("voc", paths, state, name="wave_step0K", is_silent=True)
    assert int(load_pytree(paths.get_voc_named_weights("wave_step0K"))
               ["step"]) == 7
    assert int(load_pytree(paths.voc_latest_weights)["step"]) == 7
    paths.voc_latest_optim.unlink()             # a lone weights file
    with pytest.raises(FileNotFoundError, match="exactly one"):
        save_checkpoint("voc", paths, state)
    with pytest.raises(FileNotFoundError, match="exactly one"):
        restore_checkpoint("voc", paths, state, create_if_missing=True)
    restored = restore_checkpoint("voc", paths, state, name="wave_step0K")
    assert restored.step == 7


def test_checkpoint_module_knows_no_model(tmp_path):
    """The pair rule works over any state that hands over its two trees;
    the module imports nothing of the port's models or trainer."""
    import ast

    import wavernn_tpu_torch.utils.checkpoints as ckpt

    imported = [n.module if isinstance(n, ast.ImportFrom) else a.name
                for n in ast.walk(ast.parse(Path(ckpt.__file__).read_text()))
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names]
    assert not [m for m in imported if m and m.startswith("wavernn_tpu")]

    class Trees:
        def __init__(self, k):
            self.w = {"w": np.full(3, k, np.float32), "step": np.asarray(k)}
            self.o = {"opt_state": {"count": np.asarray(k)}}

        def weights_tree(self):
            return self.w

        def optim_tree(self):
            return self.o

        def load_weights_tree(self, tree):
            self.w = tree

        def load_optim_tree(self, tree):
            self.o = tree

    paths, _ = both_paths(tmp_path)
    save_checkpoint("tts", paths, Trees(3), name="snap", is_silent=True)
    got = restore_checkpoint("tts", paths, Trees(0), name="snap")
    np.testing.assert_array_equal(got.w["w"], np.full(3, 3, np.float32))
    assert int(got.w["step"]) == 3 and int(got.o["opt_state"]["count"]) == 3
    assert paths.tts_latest_weights.exists()
