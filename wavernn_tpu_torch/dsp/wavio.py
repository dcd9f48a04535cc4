"""WAV file I/O without external audio libraries (a copy of the numpy-only
``wavernn_tpu/dsp/wavio.py``: importing that package runs its JAX DSP).

A small RIFF/WAVE parser + writer supporting PCM 8/16/24/32-bit and IEEE
float32/64, returning float32 in [-1, 1] like ``librosa.load`` (ref:
utils/dsp.py:18-23).  Resampling to a target rate uses polyphase filtering
(scipy.signal.resample_poly), matching librosa's default quality class.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav_raw(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float32 samples in [-1,1] mono-or-(n,ch), sample_rate)."""
    data = Path(path).read_bytes()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    fmt_body = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8: pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        # the effective format code is the first word of the SubFormat GUID
        # (fmt body offset 24: after cbSize, wValidBitsPerSample, dwChannelMask)
        if len(fmt_body) >= 26:
            (audio_format,) = struct.unpack_from("<H", fmt_body, 24)
        else:
            raise ValueError(f"{path}: truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            val = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")

    if channels > 1:
        x = x.reshape(-1, channels)
    return x, sample_rate


def load_wav(path: Union[str, Path], sr: Optional[int] = None,
             mono: bool = True) -> np.ndarray:
    """librosa.load-compatible loader: float32, mono-mixed, resampled to sr."""
    x, native_sr = read_wav_raw(path)
    if mono and x.ndim > 1:
        x = x.mean(axis=1)
    if sr is not None and sr != native_sr:
        from scipy.signal import resample_poly

        g = math.gcd(int(sr), int(native_sr))
        x = resample_poly(x, sr // g, native_sr // g).astype(np.float32)
    return np.ascontiguousarray(x, dtype=np.float32)


def save_wav(x: np.ndarray, path: Union[str, Path], sr: int) -> None:
    """Write mono float audio in [-1,1] as 16-bit PCM WAV."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    save_pcm16(np.round(np.clip(x * 32767.0, -32768, 32767)), path, sr)


def save_pcm16(pcm: np.ndarray, path: Union[str, Path], sr: int) -> None:
    """Write mono 16-bit PCM samples (already quantized) as a WAV file."""
    raw = np.asarray(pcm).reshape(-1).astype("<i2").tobytes()
    header = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(raw), b"WAVE",
        b"fmt ", 16, _WAVE_FORMAT_PCM, 1, sr, sr * 2, 2, 16,
        b"data", len(raw),
    )
    Path(path).write_bytes(header + raw)
