"""The msgpack checkpoints of the JAX package: reader, writer, and the
training checkpoint pairs (ports ``wavernn_tpu/utils/checkpoints.py``).

The JAX package saves pytrees with ``flax.serialization.msgpack_serialize``.
The port must read and write them on machines with neither flax nor the
``msgpack`` package, so this module encodes and decodes the subset of
msgpack that flax writes, in pure Python:

  * maps, arrays, str/bin, nil/bool, ints and floats (big-endian headers);
  * ext type 1, an ndarray: a packed ``(shape, dtype_name, bytes)`` triple,
    the bytes in C order and little-endian;
  * ext type 3, a numpy scalar: the same triple for a 0-d array.

The chunked form flax uses for arrays above 1 GiB
(``__msgpack_chunked_array__``) is refused: no checkpoint of this repository
holds one.  The writer emits what flax would for the same state dict, byte
for byte: map keys sorted (flax passes the tree through ``jax.tree_util``,
which sorts them), ints and floats in msgpack's smallest
encodings (floats as float64, as msgpack packs Python floats), and every
array, 0-d ones included, as ext type 1.

Training checkpoints keep the reference's contracts: weights and optimizer
state live in paired files, exactly 0 or 2 of a pair may exist (anything
else raises), a 'latest' pair is always rewritten and named snapshots are
additive, ``create_if_missing`` bootstraps a fresh run, and the step
counter travels with the weights.  This module knows no model: a train
state hands it the two ready-made trees and takes them back,

  * ``state.weights_tree()`` / ``state.load_weights_tree(tree)``: the
    weights file (params, norm statistics and step);
  * ``state.optim_tree()`` / ``state.load_optim_tree(tree)``: the optimizer
    file.

``training.state.TrainState`` gives them the JAX package's layouts, so a
pair resumes in either package.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos: self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        simple = {
            0xCA: "f", 0xCB: "d",
            0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q",
        }
        if t in simple:
            return self.unpack(simple[t])
        sizes = {0: "B", 1: "H", 2: "I"}
        if 0xC4 <= t <= 0xC6:                       # bin 8/16/32
            return self.take(self.unpack(sizes[t - 0xC4]))
        if 0xD9 <= t <= 0xDB:                       # str 8/16/32
            return self.take(self.unpack(sizes[t - 0xD9])).decode("utf-8")
        if t in (0xDC, 0xDD):                       # array 16/32
            return self.array(self.unpack("H" if t == 0xDC else "I"))
        if t in (0xDE, 0xDF):                       # map 16/32
            return self.map(self.unpack("H" if t == 0xDE else "I"))
        if 0xD4 <= t <= 0xD8:                       # fixext 1/2/4/8/16
            code = self.unpack("b")
            return _ext(code, self.take(1 << (t - 0xD4)))
        if 0xC7 <= t <= 0xC9:                       # ext 8/16/32
            n = self.unpack(sizes[t - 0xC7])
            code = self.unpack("b")
            return _ext(code, self.take(n))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError(
                "chunked msgpack arrays (leaves above 1 GiB) are not "
                "supported")
        return out


def _ndarray(data: bytes) -> np.ndarray:
    r = _Reader(data)
    shape, dtype_name, buf = r.value()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("ascii")
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported")
    dtype = np.dtype(dtype_name).newbyteorder("<")
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")
    return arr.astype(dtype.newbyteorder("="))


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def load_pytree(path: Union[str, Path]) -> dict:
    """Read a flax msgpack checkpoint into a nested dict of numpy arrays."""
    r = _Reader(Path(path).read_bytes())
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def _uint(n: int, fmts) -> bytes:
    """The first of ``fmts`` [(limit, type byte, struct code)] that holds n."""
    for limit, code, fmt in fmts:
        if n <= limit:
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


_LEN32 = ((0xFF, 0, "B"), (0xFFFF, 1, "H"), (0xFFFFFFFF, 2, "I"))


def _sized(base: int, n: int) -> bytes:
    """A str/bin/ext header with an 8/16/32-bit length after ``base``."""
    return _uint(n, [(lim, base + off, f) for lim, off, f in _LEN32])


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        return _uint(n, [(0xFF, 0xCC, "B"), (0xFFFF, 0xCD, "H"),
                         (0xFFFFFFFF, 0xCE, "I"), (2 ** 64 - 1, 0xCF, "Q")])
    for lo, code, fmt in ((-2 ** 7, 0xD0, "b"), (-2 ** 15, 0xD1, "h"),
                          (-2 ** 31, 0xD2, "i"), (-2 ** 63, 0xD3, "q")):
        if n >= lo:
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"int {n} too large for msgpack")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixed[len(data)]]) if len(data) in fixed
            else _sized(0xC7, len(data)))
    return head + struct.pack(">b", code) + data


def _pack(v: Any, out: list) -> None:
    if v is None:
        out.append(b"\xc0")
    elif isinstance(v, bool):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject:
            raise ValueError("object arrays cannot be saved")
        payload: list = []
        _pack((list(v.shape), v.dtype.name, v.tobytes("C")), payload)
        out.append(_pack_ext(_EXT_NDARRAY, b"".join(payload)))
    elif isinstance(v, np.generic):
        payload = []
        a = np.asarray(v)
        _pack((list(a.shape), a.dtype.name, a.tobytes("C")), payload)
        out.append(_pack_ext(_EXT_NPSCALAR, b"".join(payload)))
    elif isinstance(v, int):
        out.append(_pack_int(v))
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append((bytes([0xA0 | len(b)]) if len(b) < 32
                    else _sized(0xD9, len(b))) + b)
    elif isinstance(v, bytes):
        out.append(_sized(0xC4, len(v)) + v)
    elif isinstance(v, (list, tuple)):
        n = len(v)
        out.append(bytes([0x90 | n]) if n < 16 else _uint(
            n, [(0xFFFF, 0xDC, "H"), (0xFFFFFFFF, 0xDD, "I")]))
        for x in v:
            _pack(x, out)
    elif isinstance(v, dict):
        n = len(v)
        out.append(bytes([0x80 | n]) if n < 16 else _uint(
            n, [(0xFFFF, 0xDE, "H"), (0xFFFFFFFF, 0xDF, "I")]))
        for k, x in sorted(v.items()):
            _pack(k, out)
            _pack(x, out)
    else:
        raise TypeError(f"cannot save a {type(v).__name__} in a checkpoint")


def pack_pytree(tree: dict) -> bytes:
    """The msgpack bytes flax's ``msgpack_serialize`` gives a state dict
    (nested dicts with str keys, numpy arrays and Python scalars): keys
    sorted at every level."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def save_pytree(tree: dict, path: Union[str, Path]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(pack_pytree(tree))


# -- training checkpoints ---------------------------------------------------


def get_checkpoint_paths(checkpoint_type: str, paths):
    if checkpoint_type == "tts":
        return paths.tts_latest_weights, paths.tts_latest_optim, paths.tts_checkpoints
    if checkpoint_type == "voc":
        return paths.voc_latest_weights, paths.voc_latest_optim, paths.voc_checkpoints
    raise NotImplementedError(checkpoint_type)


def _pair(checkpoint_type: str, paths, name: Optional[str]):
    weights_path, optim_path, checkpoint_path = get_checkpoint_paths(
        checkpoint_type, paths)
    if name:
        return (checkpoint_path / f"{name}_weights.msgpack",
                checkpoint_path / f"{name}_optim.msgpack", "named")
    return weights_path, optim_path, "latest"


def save_checkpoint(checkpoint_type: str, paths, state, *,
                    name: Optional[str] = None, is_silent: bool = False) -> None:
    """Write the latest pair (always) and optionally a named snapshot pair."""

    def helper(w_path: Path, o_path: Path, s: str):
        num_exist = sum(p.exists() for p in (w_path, o_path))
        if num_exist not in (0, 2):
            raise FileNotFoundError(
                f"Expected both or neither file of the {s} checkpoint to "
                "exist, but found exactly one!"
            )
        if not is_silent:
            verb = "Creating" if num_exist == 0 else "Saving to existing"
            print(f"{verb} {s} checkpoint...")
            print(f"Saving {s} weights: {w_path}")
        save_pytree(state.weights_tree(), w_path)
        if not is_silent:
            print(f"Saving {s} optimizer state: {o_path}")
        save_pytree(state.optim_tree(), o_path)

    helper(*_pair(checkpoint_type, paths, None))
    if name:
        helper(*_pair(checkpoint_type, paths, name))


def restore_checkpoint(checkpoint_type: str, paths, state, *,
                       name: Optional[str] = None,
                       create_if_missing: bool = False):
    """Restore a training state from disk into ``state`` (a freshly
    initialized one: its model and optimizer layout are the template).
    Returns the restored state."""
    w_path, o_path, s = _pair(checkpoint_type, paths, name)
    num_exist = sum(p.exists() for p in (w_path, o_path))
    if num_exist == 2:
        print(f"Restoring from {s} checkpoint...")
        print(f"Loading {s} weights: {w_path}")
        load_weights(state, w_path)
        print(f"Loading {s} optimizer state: {o_path}")
        state.load_optim_tree(load_pytree(o_path))
        return state
    if create_if_missing:   # with one file of the pair, the save raises
        save_checkpoint(checkpoint_type, paths, state, name=name,
                        is_silent=False)
        return state
    raise FileNotFoundError(f"The {s} checkpoint could not be found!")


def load_weights(state, path: Path):
    """Load a weights-only file onto a state (inference path, ref
    WaveRNN.load).  The optimizer state is untouched."""
    state.load_weights_tree(load_pytree(path))
    return state


def save_weights(state, path: Path):
    """Save a weights-only file (ref WaveRNN.save: no optimizer data)."""
    save_pytree(state.weights_tree(), path)
