"""Audio quality metrics: MCD (mel cepstral distortion), the parity gate
between the vocoder's output and its input mel (ports
``wavernn_tpu/dsp/metrics.py``).  The DCT-II is a numpy matrix with ortho
norm, equal to ``scipy.fftpack.dct(x, type=2, norm="ortho")``, so the
gate needs no scipy."""

from __future__ import annotations

import numpy as np


def dct2_ortho_matrix(n: int) -> np.ndarray:
    """(n, n) orthonormal DCT-II matrix: ``D @ x`` is the DCT-II of ``x``
    along its first axis with ortho norm."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    D = np.sqrt(2.0 / n) * np.cos(np.pi * k * (2.0 * i + 1.0) / (2.0 * n))
    D[0] *= np.sqrt(0.5)
    return D


def mel_to_cepstra(mel_db: np.ndarray, n_mfcc: int = 13) -> np.ndarray:
    """dB-scale mel spectrogram (n_mels, T) -> cepstra (n_mfcc, T) via
    DCT-II with ortho norm (the standard MFCC construction)."""
    mel_db = np.asarray(mel_db, np.float64)
    return (dct2_ortho_matrix(mel_db.shape[0]) @ mel_db)[:n_mfcc]


def mcd(mel_a: np.ndarray, mel_b: np.ndarray, n_mfcc: int = 13,
        skip_c0: bool = True) -> float:
    """Mean mel-cepstral distortion in dB between two aligned normalized
    mel spectrograms (n_mels, T) in [0, 1].

    Uses the standard 10*sqrt(2)/ln(10) scaling over cepstra 1..n_mfcc-1
    (c0, the overall energy, skipped by convention)."""
    if mel_a.shape != mel_b.shape:
        raise ValueError(f"mel shapes differ: {mel_a.shape} {mel_b.shape}")
    # [0,1] normalized -> dB relative scale (min_level_db = -100)
    a_db = np.asarray(mel_a, np.float64) * 100.0
    b_db = np.asarray(mel_b, np.float64) * 100.0
    ca = mel_to_cepstra(a_db, n_mfcc)
    cb = mel_to_cepstra(b_db, n_mfcc)
    if skip_c0:
        ca, cb = ca[1:], cb[1:]
    k = 10.0 * np.sqrt(2.0) / np.log(10.0)
    return float(np.mean(k * np.sqrt(np.sum((ca - cb) ** 2, axis=0))))
