"""The port's device DSP and Griffin-Lim vocoder
(``wavernn_tpu_torch/dsp/torch_audio.py``) against
``wavernn_tpu/dsp/jax_audio.py`` on the CPU.

Seeded numpy input (a 220 Hz tone plus noise, 0.5 s) through both
packages with the repository's hparams.py.  Tolerances (both float32):
the complex STFT within 1e-3 (its values reach ~80), the iSTFT within
1e-5, the normalized mel within 1e-4, the NNLS projection within 1e-5 of
its largest value (the two pseudo-inverses differ in rounding), and
Griffin-Lim from JAX's own initial phase (``jax.random.uniform`` of
``PRNGKey(0)`` in [0, 2 pi)), 8 iterations, within 1e-4.
``reconstruct_waveform`` must pass the 440 Hz tone criterion of
``tests/test_dsp.py::test_griffinlim_reconstructs_tone``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.config import hp as port_hp
from wavernn_tpu_torch.dsp import audio, torch_audio
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
N_FFT, HOP, WIN = 2048, 275, 1100


@pytest.fixture(scope="module")
def both_hp():
    from wavernn_tpu.config import hp as jax_hp

    for hp in (jax_hp, port_hp):
        hp.reset()
        hp.configure(REPO / "hparams.py")
    yield
    for hp in (jax_hp, port_hp):
        hp.reset()


def _signal(n=22050 // 2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal(n)
            ).astype(np.float32)


def test_stft_and_istft_match_jax():
    import jax.numpy as jnp

    from wavernn_tpu.dsp import jax_audio

    y = _signal()
    want = np.asarray(jax_audio.stft(jnp.asarray(y), N_FFT, HOP, WIN))
    got = torch_audio.stft(torch.from_numpy(y), N_FFT, HOP, WIN)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), audio.stft_np(y, N_FFT, HOP, WIN),
                               atol=1e-3)
    want = want.copy()
    inv = torch_audio.istft(torch.from_numpy(want), HOP, WIN,
                            length=len(y)).numpy()
    np.testing.assert_allclose(
        inv, np.asarray(jax_audio.istft(jnp.asarray(want), HOP, WIN,
                                        length=len(y))), atol=1e-5)
    n = (want.shape[1] - 1) * HOP              # the samples frames cover
    np.testing.assert_allclose(inv[:n], y[:n], atol=1e-5)      # round trip
    short = torch_audio.istft(torch.from_numpy(want), HOP, WIN,
                              length=len(y) + 7)
    assert short.shape == (len(y) + 7,) and float(short[-7:].abs().max()) == 0


def test_melspectrogram_hp_matches_jax(both_hp):
    from wavernn_tpu.dsp import jax_audio

    y = _signal(seed=1)
    want = np.asarray(jax_audio.melspectrogram_hp(y))
    got = torch_audio.melspectrogram_hp(y, device="cpu").numpy()
    assert got.shape == want.shape == (80, 1 + len(y) // HOP)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_nnls_projection_matches_jax():
    import jax.numpy as jnp

    from wavernn_tpu.dsp import jax_audio

    basis = audio.mel_filterbank(22050, N_FFT, 80, fmin=40).astype(np.float32)
    M = (basis @ np.abs(audio.stft_np(_signal(seed=2), N_FFT, HOP, WIN))
         ).astype(np.float32)
    want = np.asarray(jax_audio._nnls_project(jnp.asarray(basis),
                                              jnp.asarray(M)))
    got = torch_audio._nnls_project(torch.from_numpy(basis),
                                    torch.from_numpy(M)).numpy()
    assert got.shape == want.shape and got.min() >= 0
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_griffinlim_from_jax_phase_matches_jax():
    import jax
    import jax.numpy as jnp

    from wavernn_tpu.dsp import jax_audio

    S = np.abs(audio.stft_np(_signal(seed=3), N_FFT, HOP, WIN)).astype(
        np.float32)
    key = jax.random.PRNGKey(0)
    phase = np.array(jax.random.uniform(key, S.shape, minval=0.0,
                                        maxval=2 * jnp.pi))
    want = np.asarray(jax_audio.griffinlim(jnp.asarray(S), key, n_iter=8,
                                           hop_length=HOP, win_length=WIN))
    got = torch_audio.griffinlim(torch.from_numpy(S),
                                 torch.from_numpy(phase), 8, HOP, WIN)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_reconstruct_waveform_gives_back_a_tone(both_hp, monkeypatch):
    sr = 22050
    t = np.arange(sr // 2) / sr
    mel = audio.melspectrogram((0.5 * np.sin(2 * np.pi * 440 * t)
                                ).astype(np.float32))
    wav = torch_audio.reconstruct_waveform(mel, n_iter=32, device="cpu")
    assert wav.dtype == np.float32 and wav.shape == ((mel.shape[1] - 1)
                                                     * HOP,)
    spec = np.abs(np.fft.rfft(wav * np.hanning(len(wav))))
    freqs = np.fft.rfftfreq(len(wav), 1 / sr)
    band = (freqs > 200) & (freqs < 900)
    centroid = (freqs[band] * spec[band]).sum() / spec[band].sum()
    assert abs(centroid - 440) < 50
    assert spec[band].sum() / spec.sum() > 0.8
    again = torch_audio.reconstruct_waveform(mel, n_iter=32, device="cpu")
    np.testing.assert_array_equal(again, wav)          # seeded phase
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_audio.reconstruct_waveform(mel, n_iter=1)   # cuda by default
