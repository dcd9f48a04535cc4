"""Reader for the msgpack checkpoints the JAX package writes.

The JAX package saves pytrees with ``flax.serialization.msgpack_serialize``.
The port must load them on machines with neither flax nor the ``msgpack``
package, so this module decodes the subset of msgpack that flax writes, in
pure Python:

  * maps, arrays, str/bin, nil/bool, ints and floats (big-endian headers);
  * ext type 1, an ndarray: a packed ``(shape, dtype_name, bytes)`` triple,
    the bytes in C order and little-endian;
  * ext type 3, a numpy scalar: the same triple for a 0-d array.

The chunked form flax uses for arrays above 1 GiB
(``__msgpack_chunked_array__``) is refused: no checkpoint of this repository
holds one.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Union

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
