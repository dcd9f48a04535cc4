"""Host-side (numpy) DSP matching the reference's librosa conventions (a
copy of ``wavernn_tpu/dsp/audio.py`` that reads ``hp`` from
``wavernn_tpu_torch/config.py``).

Feature definitions (ref: utils/dsp.py:41-103, hparams.py:20-31):
  mel   = normalize(amp_to_db(mel_basis @ |STFT(y)|))
  quant = mu-law labels (RAW) or 16-bit labels (MOL)

STFT convention = librosa defaults: centered frames (reflect padding of
n_fft//2), periodic Hann window of ``win_length`` zero-padded to ``n_fft``.
Mel filterbank = Slaney scale + Slaney area normalization (librosa defaults).
These choices are what the published pretrained checkpoints assume; MCD
parity against the reference depends on them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import wavio

# ---------------------------------------------------------------------------
# label <-> float codecs (ref: utils/dsp.py:8-38)
# ---------------------------------------------------------------------------


def label_2_float(x, bits):
    """Integer class labels [0, 2**bits) → float amplitude [-1, 1]."""
    return 2 * x / (2 ** bits - 1.0) - 1.0


def float_2_label(x, bits):
    """Float amplitude [-1, 1] → integer class labels [0, 2**bits)."""
    assert abs(x).max() <= 1.0
    x = (x + 1.0) * (2 ** bits - 1) / 2
    return x.clip(0, 2 ** bits - 1)


def split_signal(x):
    """16-bit signal → (coarse, fine) 8-bit pair (DeepMind dual-softmax)."""
    unsigned = x + 2 ** 15
    coarse = unsigned // 256
    fine = unsigned % 256
    return coarse, fine


def combine_signal(coarse, fine):
    """(coarse, fine) 8-bit pair → 16-bit signal."""
    return coarse * 256 + fine - 2 ** 15


def encode_16bits(x):
    return np.clip(x * 2 ** 15, -2 ** 15, 2 ** 15 - 1).astype(np.int16)


# ---------------------------------------------------------------------------
# mu-law companding (ref: utils/dsp.py:92-103)
# ---------------------------------------------------------------------------


def encode_mu_law(x, mu):
    """Float [-1,1] → mu-law class labels [0, mu)."""
    mu = mu - 1
    fx = np.sign(x) * np.log(1 + mu * np.abs(x)) / np.log(1 + mu)
    return np.floor((fx + 1) / 2 * mu + 0.5)


def decode_mu_law(y, mu, from_labels=True):
    """Mu-law labels (or compressed floats) → float [-1,1]."""
    if from_labels:
        y = label_2_float(y, math.log2(mu))
    mu = mu - 1
    x = np.sign(y) / mu * ((1 + mu) ** np.abs(y) - 1)
    return x


# ---------------------------------------------------------------------------
# STFT + mel filterbank (librosa conventions, reimplemented)
# ---------------------------------------------------------------------------


def hann_window(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, matching scipy/librosa."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window of win_length zero-padded (centered) to n_fft."""
    if win_length > n_fft:
        raise ValueError("win_length may not exceed n_fft")
    w = hann_window(win_length)
    lpad = (n_fft - win_length) // 2
    return np.pad(w, (lpad, n_fft - win_length - lpad))


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mels = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asanyarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangular mel filterbank
    (librosa.filters.mel defaults), shape (n_mels, 1 + n_fft // 2)."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(np.float64(fmin)),
                    _hz_to_mel_slaney(np.float64(fmax)), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])  # Slaney area norm
    weights *= enorm[:, None]
    return weights.astype(np.float64)


def frame_signal(y: np.ndarray, n_fft: int, hop_length: int) -> np.ndarray:
    """Strided view of y in (n_fft, n_frames) column-frame layout."""
    n_frames = 1 + (len(y) - n_fft) // hop_length
    stride = y.strides[0]
    return np.lib.stride_tricks.as_strided(
        y, shape=(n_fft, n_frames), strides=(stride, hop_length * stride)
    )


def stft_np(y: np.ndarray, n_fft: int, hop_length: int, win_length: int,
            center: bool = True) -> np.ndarray:
    """Complex STFT, shape (1 + n_fft//2, n_frames), librosa framing."""
    y = np.asarray(y, dtype=np.float64)
    window = padded_window(win_length, n_fft)
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    frames = frame_signal(y, n_fft, hop_length)
    return np.fft.rfft(frames * window[:, None], axis=0)


def istft_np(D: np.ndarray, hop_length: int, win_length: int,
             center: bool = True, length: Optional[int] = None) -> np.ndarray:
    """Inverse STFT via windowed overlap-add with window-sum-square norm."""
    n_fft = 2 * (D.shape[0] - 1)
    window = padded_window(win_length, n_fft)
    frames = np.fft.irfft(D, n=n_fft, axis=0) * window[:, None]
    n_frames = D.shape[1]
    expected = n_fft + hop_length * (n_frames - 1)
    y = np.zeros(expected)
    wss = np.zeros(expected)
    w2 = window ** 2
    for t in range(n_frames):
        s = t * hop_length
        y[s: s + n_fft] += frames[:, t]
        wss[s: s + n_fft] += w2
    y = y / np.maximum(wss, 1e-10)
    if center:
        y = y[n_fft // 2: expected - n_fft // 2]
    if length is not None:
        y = y[:length] if len(y) >= length else np.pad(y, (0, length - len(y)))
    return y


# ---------------------------------------------------------------------------
# hp-bound feature API (ref: utils/dsp.py:41-81)
# ---------------------------------------------------------------------------

_mel_basis_cache = {}


def _mel_basis() -> np.ndarray:
    key = (hp.sample_rate, hp.n_fft, hp.num_mels, hp.fmin)
    if key not in _mel_basis_cache:
        _mel_basis_cache[key] = mel_filterbank(
            hp.sample_rate, hp.n_fft, hp.num_mels, fmin=hp.fmin
        )
    return _mel_basis_cache[key]


def load_wav(path):
    return wavio.load_wav(path, sr=hp.sample_rate)


def save_wav(x, path):
    wavio.save_wav(np.asarray(x, dtype=np.float32), path, sr=hp.sample_rate)


def linear_to_mel(spectrogram):
    return _mel_basis() @ spectrogram


def normalize(S):
    return np.clip((S - hp.min_level_db) / -hp.min_level_db, 0, 1)


def denormalize(S):
    return (np.clip(S, 0, 1) * -hp.min_level_db) + hp.min_level_db


def amp_to_db(x):
    return 20 * np.log10(np.maximum(1e-5, x))


def db_to_amp(x):
    return np.power(10.0, x * 0.05)


def spectrogram(y):
    D = stft(y)
    S = amp_to_db(np.abs(D)) - hp.ref_level_db
    return normalize(S)


def melspectrogram(y):
    D = stft(y)
    S = amp_to_db(linear_to_mel(np.abs(D)))
    return normalize(S)


def stft(y):
    return stft_np(y, n_fft=hp.n_fft, hop_length=hp.hop_length,
                   win_length=hp.win_length)


def pre_emphasis(x):
    from scipy.signal import lfilter

    return lfilter([1, -hp.preemphasis], [1], x)


def de_emphasis(x):
    from scipy.signal import lfilter

    return lfilter([1], [1, -hp.preemphasis], x)
