"""The port's host DSP and the copy-synthesis MCD gate, against the JAX
package.

``wavernn_tpu_torch.dsp.audio`` is a copy of ``wavernn_tpu.dsp.audio``
that reads the port's ``hp``: every function must give the JAX one's
result on the same seeded input to 1e-12 (both are float64 numpy), and the
feature pipeline must reproduce the committed pins (the two-tone mel to
1e-6 and its mu-law labels exactly, as ``tests/test_golden.py`` holds the
JAX package; the Slaney filterbank to 1e-14).  ``dsp.metrics.mcd`` uses a
numpy DCT-II matrix in place of ``scipy.fftpack.dct``: the matrix must
equal scipy's transform to 1e-12 and ``mcd`` the JAX package's to 1e-9.
``infer.eval.copy_synthesis_mcd`` on the committed tiny RAW golden
(deterministic) must score the JAX package's wav to 1e-9; the port's
float32 scan backend must score within 1e-3 dB of the JAX scan, and its
kernel backend (the plain version: bf16 products, int8 recurrent
matrices, so the argmax trajectory drifts) within 1% of it, and through
int16 egress within 1% of its float egress."""

from pathlib import Path

import numpy as np
import pytest

from wavernn_tpu.dsp import audio as jax_audio
from wavernn_tpu.dsp import metrics as jax_metrics
from wavernn_tpu_torch.config import hp as port_hp
from wavernn_tpu_torch.dsp import audio, metrics
from tests.torch_cpu import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
REPO = Path(__file__).parent.parent


@pytest.fixture()
def both_hp():
    """The repository's hparams.py in both packages' ``hp``, with the
    pre-emphasis coefficient it leaves out."""
    from wavernn_tpu.config import hp as jax_hp

    for hp in (jax_hp, port_hp):
        hp.reset()
        hp.configure(REPO / "hparams.py", data_path="data/",
                     preemphasis=0.97)
    yield port_hp
    for hp in (jax_hp, port_hp):
        hp.reset()


def _signal(n=22050 // 2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    return (0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal(n)
            ).astype(np.float32)


def _two_tone():
    sr = 22050
    t = np.arange(sr // 4) / sr
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.25 * np.sin(2 * np.pi * 1320 * t)).astype(np.float32)


_rng = np.random.default_rng(7)
_AMP = _rng.uniform(-1, 1, 4000)
_SPEC = np.abs(_rng.standard_normal((1025, 12))) + 1e-3
CASES = {
    "label_2_float": (lambda m: m.label_2_float(np.arange(512), 9)),
    "float_2_label": (lambda m: m.float_2_label(_AMP, 9)),
    "split_signal": (lambda m: m.split_signal(
        np.arange(-2 ** 15, 2 ** 15, 97))),
    "combine_signal": (lambda m: m.combine_signal(
        np.arange(256)[:, None], np.arange(256)[None, :])),
    "encode_16bits": (lambda m: m.encode_16bits(_AMP * 1.1)),
    "encode_mu_law": (lambda m: m.encode_mu_law(_AMP, 512)),
    "decode_mu_law": (lambda m: m.decode_mu_law(np.arange(512), 512)),
    "decode_mu_law_floats": (lambda m: m.decode_mu_law(_AMP, 256, False)),
    "hann_window": (lambda m: m.hann_window(1100)),
    "padded_window": (lambda m: m.padded_window(1100, 2048)),
    "mel_filterbank": (lambda m: m.mel_filterbank(22050, 2048, 80, 40.0)),
    "stft_np": (lambda m: m.stft_np(_signal(), 2048, 275, 1100)),
    "istft_np": (lambda m: m.istft_np(
        m.stft_np(_signal(), 2048, 275, 1100), 275, 1100,
        length=22050 // 2)),
    "linear_to_mel": (lambda m: m.linear_to_mel(_SPEC)),
    "normalize": (lambda m: m.normalize(_AMP * 150.0 - 50.0)),
    "denormalize": (lambda m: m.denormalize(_AMP)),
    "amp_to_db": (lambda m: m.amp_to_db(np.abs(_AMP))),
    "db_to_amp": (lambda m: m.db_to_amp(_AMP * 40.0)),
    "spectrogram": (lambda m: m.spectrogram(_signal(seed=1))),
    "melspectrogram": (lambda m: m.melspectrogram(_signal(seed=2))),
    "stft": (lambda m: m.stft(_signal(seed=3))),
    "pre_emphasis": (lambda m: m.pre_emphasis(_signal(seed=4))),
    "de_emphasis": (lambda m: m.de_emphasis(_signal(seed=5))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_audio_function_matches_jax(both_hp, name):
    got, want = CASES[name](audio), CASES[name](jax_audio)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_wav_roundtrip_matches_jax(both_hp, tmp_path):
    x = _signal(seed=6)
    audio.save_wav(x, tmp_path / "port.wav")
    jax_audio.save_wav(x, tmp_path / "jax.wav")
    assert ((tmp_path / "port.wav").read_bytes()
            == (tmp_path / "jax.wav").read_bytes())
    np.testing.assert_array_equal(audio.load_wav(tmp_path / "port.wav"),
                                  jax_audio.load_wav(tmp_path / "jax.wav"))


def test_feature_pins(both_hp):
    mel = audio.melspectrogram(_two_tone()).astype(np.float32)
    np.testing.assert_allclose(mel, np.load(GOLDEN / "mel_two_tone.npy"),
                               atol=1e-6)
    labels = audio.encode_mu_law(_two_tone(), 512).astype(np.int16)[:500]
    np.testing.assert_array_equal(labels,
                                  np.load(GOLDEN / "mulaw_two_tone.npy"))
    fb = np.load(GOLDEN /
                 "mel_filterbank_slaney_sr22050_nfft2048_n80_fmin40.npy")
    np.testing.assert_allclose(audio.mel_filterbank(22050, 2048, 80, 40.0),
                               fb, atol=1e-14)


def test_package_exports_the_audio_api():
    import wavernn_tpu_torch.dsp as dsp

    for name in ("melspectrogram", "encode_mu_law", "decode_mu_law",
                 "load_wav", "save_wav", "mel_filterbank", "stft"):
        assert getattr(dsp, name) is getattr(audio, name)
    from wavernn_tpu_torch.dsp import torch_audio

    assert dsp.reconstruct_waveform is torch_audio.reconstruct_waveform


@pytest.mark.parametrize("n", [1, 2, 13, 80])
def test_dct_matrix_matches_scipy(n):
    from scipy.fftpack import dct

    x = np.random.default_rng(n).standard_normal((n, 9))
    np.testing.assert_allclose(metrics.dct2_ortho_matrix(n) @ x,
                               dct(x, type=2, axis=0, norm="ortho"),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("skip_c0", [True, False])
def test_mcd_matches_jax(skip_c0):
    rng = np.random.default_rng(11)
    a, b = rng.uniform(0, 1, (2, 80, 57))
    got = metrics.mcd(a, b, skip_c0=skip_c0)
    assert got == pytest.approx(jax_metrics.mcd(a, b, skip_c0=skip_c0),
                                abs=1e-9)
    assert metrics.mcd(a, a) == 0.0
    with pytest.raises(ValueError, match="shapes"):
        metrics.mcd(a, b[:, :50])


def test_copy_synthesis_mcd_matches_jax(both_hp):
    from wavernn_tpu.infer.eval import copy_synthesis_mcd as jax_csm
    from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
    from wavernn_tpu.ops.decode import Generator as JaxGenerator
    from wavernn_tpu_torch.infer.eval import copy_synthesis_mcd
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    blob = load_pytree(GOLDEN / "tiny_wavernn_raw.msgpack")
    v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    kw = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
              res_blocks=2, mode="RAW")
    mel = np.load(GOLDEN / "tiny_wavernn_raw_mel.npy")[:, :60]
    geom = dict(batched=True, target=2750, overlap=550, mu_law=True)
    jgen = JaxGenerator(JaxConfig(**kw), v, backend="scan", frame_bucket=16,
                        deterministic=True)
    want, jwav = jax_csm(jgen, mel, **geom)
    # the port's MCD of the JAX wav is the JAX package's MCD
    regen = audio.melspectrogram(np.asarray(jwav, np.float32))
    T = min(mel.shape[1], regen.shape[1])
    assert metrics.mcd(mel[:, :T], regen[:, :T]) == pytest.approx(
        want, abs=1e-9)
    for backend in ("scan", "kernel"):
        gen = Generator(WaveRNNConfig(**kw), v, device="cpu",
                        frame_bucket=16, deterministic=True, backend=backend)
        got, wav = copy_synthesis_mcd(gen, mel, **geom)
        assert wav.shape == jwav.shape and np.isfinite(got)
        assert abs(got - want) <= (1e-3 if backend == "scan"
                                   else 0.01 * want), (backend, got, want)
    # packed egress scored through the client's decoder
    gen16 = Generator(WaveRNNConfig(**kw), v, device="cpu", frame_bucket=16,
                      deterministic=True, output_dtype="int16")
    seen = []
    got16, _ = copy_synthesis_mcd(
        gen16, mel, **geom,
        to_float=lambda w: seen.append(w.dtype) or w / 32767.0)
    assert seen == [np.int16]
    assert abs(got16 - got) <= 0.01 * got


def test_eval_testset_mcd_scores_each_utterance(both_hp, capsys):
    from wavernn_tpu_torch.infer.eval import copy_synthesis_mcd, \
        eval_testset_mcd
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    blob = load_pytree(GOLDEN / "tiny_wavernn_raw.msgpack")
    v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    cfg = WaveRNNConfig(rnn_dims=32, fc_dims=32, compute_dims=16,
                        res_out_dims=16, res_blocks=2, mode="RAW")
    mel = np.load(GOLDEN / "tiny_wavernn_raw_mel.npy")
    test_set = [(mel[:, :12], None), (mel[:, 40:50], None), (mel, None)]
    scores = eval_testset_mcd(cfg, v, test_set, samples=2, batched=True,
                              target=200, overlap=28, device="cpu")
    assert len(scores) == 2 and "mean copy-synthesis MCD" in \
        capsys.readouterr().out
    # sampling decode, seed 0: the same as one copy_synthesis_mcd call
    want, _ = copy_synthesis_mcd(Generator(cfg, v, device="cpu"),
                                 mel[:, :12], batched=True, target=200,
                                 overlap=28, mu_law=True)
    assert scores[0] == want
