"""DSP on the device: STFT / iSTFT, the mel pipeline and the Griffin-Lim
vocoder in PyTorch (the counterpart of ``wavernn_tpu/dsp/jax_audio.py``).

The conventions are :mod:`wavernn_tpu_torch.dsp.audio`'s, not
``torch.stft``'s: frames are cut after a reflect pad of ``n_fft // 2``,
windowed by ``audio.padded_window`` (a Hann window of ``win_length``
centred in ``n_fft``), and the inverse overlap-adds the windowed frames
and divides by the window's sum of squares floored at 1e-10.  The
mel -> waveform fallback inverts the mel by projected-gradient NNLS and
reconstructs the phase by momentum Griffin-Lim, all on ``device``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import audio


def _window(win_length: int, n_fft: int, device) -> torch.Tensor:
    return torch.as_tensor(audio.padded_window(win_length, n_fft),
                           dtype=torch.float32, device=device)


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         center: bool = True) -> torch.Tensor:
    """Complex64 STFT, (1 + n_fft // 2, n_frames)."""
    y = y.to(torch.float32)
    if center:
        y = F.pad(y[None, None], (n_fft // 2, n_fft // 2),
                  mode="reflect")[0, 0]
    frames = y.unfold(0, n_fft, hop_length) * _window(win_length, n_fft,
                                                      y.device)
    return torch.fft.rfft(frames, dim=-1).T


def istft(D: torch.Tensor, hop_length: int, win_length: int,
          center: bool = True, length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT: overlap-add of the windowed frames, divided by the
    window's sum of squares (floored at 1e-10)."""
    n_fft = 2 * (D.shape[0] - 1)
    n_frames = D.shape[1]
    window = _window(win_length, n_fft, D.device)
    frames = torch.fft.irfft(D.T, n=n_fft, dim=-1) * window
    expected = n_fft + hop_length * (n_frames - 1)

    def overlap_add(cols: torch.Tensor) -> torch.Tensor:
        # (n_frames, n_fft) -> (expected,): F.fold sums each output sample
        # over the frames that cover it
        return F.fold(cols.T[None], (1, expected), (1, n_fft),
                      stride=(1, hop_length))[0, 0, 0]

    y = overlap_add(frames)
    wss = overlap_add((window ** 2).expand(n_frames, n_fft))
    y = y / torch.clamp(wss, min=1e-10)
    if center:
        y = y[n_fft // 2: expected - n_fft // 2]
    if length is not None:
        y = y[:length] if y.shape[0] >= length else F.pad(
            y, (0, length - y.shape[0]))
    return y


# ---------------------------------------------------------------------------
# Mel features
# ---------------------------------------------------------------------------


def melspectrogram(y: torch.Tensor, *, sample_rate: int, n_fft: int,
                   hop_length: int, win_length: int, num_mels: int,
                   fmin: float, min_level_db: float) -> torch.Tensor:
    """wav -> normalized mel on ``y``'s device (the numpy twin is
    ``audio.melspectrogram``)."""
    basis = torch.as_tensor(
        audio.mel_filterbank(sample_rate, n_fft, num_mels, fmin=fmin),
        dtype=torch.float32, device=y.device)
    S = basis @ stft(y, n_fft, hop_length, win_length).abs()
    S_db = 20.0 * torch.log10(torch.clamp(S, min=1e-5))
    return torch.clamp((S_db - min_level_db) / -min_level_db, 0.0, 1.0)


def melspectrogram_hp(y, device="cuda") -> torch.Tensor:
    """The mel pipeline with the configured ``hp``, on ``device``."""
    return melspectrogram(
        torch.as_tensor(np.asarray(y), device=_device_of(device)),
        sample_rate=hp.sample_rate, n_fft=hp.n_fft,
        hop_length=hp.hop_length, win_length=hp.win_length,
        num_mels=hp.num_mels, fmin=hp.fmin, min_level_db=hp.min_level_db)


# ---------------------------------------------------------------------------
# Griffin-Lim fallback vocoder (mel -> linear -> waveform)
# ---------------------------------------------------------------------------


def _nnls_project(basis: torch.Tensor, M: torch.Tensor,
                  n_steps: int = 60) -> torch.Tensor:
    """Projected-gradient non-negative least squares, argmin_{X >= 0}
    |BX - M|^2: from the clipped pseudo-inverse solution, ``n_steps`` steps
    of 1/L with L = ||B^T B||_2 estimated by 16 power iterations."""
    X = torch.clamp(torch.linalg.pinv(basis) @ M, min=0.0)
    BtB = basis.T @ basis
    v = torch.ones(BtB.shape[0], dtype=BtB.dtype, device=BtB.device)
    for _ in range(16):
        v = BtB @ v
        v = v / (torch.linalg.norm(v) + 1e-12)
    L = torch.dot(v, BtB @ v) + 1e-6
    BtM = basis.T @ M
    for _ in range(n_steps):
        X = torch.clamp(X - (BtB @ X - BtM) / L, min=0.0)
    return X


def griffinlim(S: torch.Tensor, phase: torch.Tensor, n_iter: int,
               hop_length: int, win_length: int, momentum: float = 0.99,
               length: Optional[int] = None) -> torch.Tensor:
    """Momentum Griffin-Lim phase reconstruction from a magnitude STFT,
    starting from the angles ``phase`` (shaped like ``S``)."""
    S = S.to(torch.float32)
    n_fft = 2 * (S.shape[0] - 1)
    angles = torch.exp(1j * phase.to(torch.float32)).to(torch.complex64)
    rebuilt_prev = torch.zeros_like(angles)
    for _ in range(n_iter):
        inverse = istft(S * angles, hop_length, win_length, length=length)
        rebuilt = stft(inverse, n_fft, hop_length, win_length)
        angles = rebuilt - (momentum / (1 + momentum)) * rebuilt_prev
        angles = angles / (angles.abs() + 1e-16)
        rebuilt_prev = rebuilt
    return istft(S * angles, hop_length, win_length, length=length)


def mel_to_linear(mel, device="cuda") -> torch.Tensor:
    """Normalized mel [0, 1] -> the non-negative linear magnitude
    spectrogram whose mel is nearest to it (NNLS), on ``device``."""
    dev = _device_of(device)
    set_float32_policy()
    with torch.no_grad():
        mel = torch.as_tensor(np.asarray(mel), dtype=torch.float32,
                              device=dev)
        denorm = (torch.clamp(mel, 0, 1) * -hp.min_level_db
                  + hp.min_level_db)
        basis = torch.as_tensor(
            audio.mel_filterbank(hp.sample_rate, hp.n_fft, hp.num_mels,
                                 fmin=hp.fmin),
            dtype=torch.float32, device=dev)
        return _nnls_project(basis, torch.pow(10.0, denorm * 0.05))


def reconstruct_waveform(mel, n_iter: int = 32, seed: int = 0,
                         device="cuda") -> np.ndarray:
    """Normalized mel [0, 1] -> float32 waveform through NNLS mel
    inversion and Griffin-Lim on ``device`` (the vocoder-free fallback).
    The initial phase is uniform in [0, 2 pi), drawn from a
    ``torch.Generator`` on ``device`` seeded by ``seed``."""
    S = mel_to_linear(mel, device)
    with torch.no_grad():
        gen = torch.Generator(device=S.device).manual_seed(seed)
        phase = torch.rand(S.shape, generator=gen,
                           device=S.device) * (2 * math.pi)
        wav = griffinlim(S, phase, n_iter=n_iter, hop_length=hp.hop_length,
                         win_length=hp.win_length)
    return wav.cpu().numpy().astype(np.float32)


def _device_of(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not "
                           "available")
    return dev
