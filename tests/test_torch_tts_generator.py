"""The port's ``TTSGenerator`` against the committed tiny Tacotron golden
and against the JAX package's generator.

The golden (trained, D=128, H=256, r=2, eval text "abcdeabcde") decodes
on the CPU through the port's plain float32 decoder: its mel must equal the
pinned ``tiny_tacotron_mel.npy`` (116 frames) within 1e-3, the tolerance
``tests/test_golden.py`` gives the JAX decode, and its attention gates must
hold.  Against JAX's ``TTSGenerator(backend="xla")`` on the same weights
the mel, linear and attention agree within 1e-3 (float32 on both sides; the
sums are taken in other orders, and a trained autoregressive decode
carries such differences forward), with equal frame counts.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu.infer.tacotron import TTSGenerator as JaxTTSGenerator
from wavernn_tpu.models.tacotron import TacotronConfig as JaxConfig
from wavernn_tpu_torch.infer.gates import gates_pass, tts_gates
from wavernn_tpu_torch.infer.tacotron import TTSGenerator
from wavernn_tpu_torch.models.tacotron import TacotronConfig
from wavernn_tpu_torch.ops import cuda_tts
from wavernn_tpu_torch.parallel.mesh import MeshPlan
from wavernn_tpu_torch.text import text_to_sequence
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
META = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())
PINNED = META["pinned_gates_cpu_xla"]
ATOL = 1e-3


@pytest.fixture(scope="module")
def golden():
    blob = load_pytree(GOLDEN / "tiny_tacotron.msgpack")
    v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    seq = text_to_sequence(META["eval_text"], ["english_cleaners"])
    gt = np.load(GOLDEN / "tiny_tacotron_gt_mel.npy") * 8.0 - 4.0
    return TacotronConfig(**META["dims"]), v, seq, gt


@pytest.fixture(scope="module")
def jax_gen(golden):
    _, v, _, _ = golden
    return JaxTTSGenerator(JaxConfig(**META["dims"]), v, steps=400,
                           backend="xla")


def test_golden_mel_pinned_without_jax(golden):
    cfg, v, seq, gt = golden
    gen = TTSGenerator(cfg, v, "cpu", steps=400, stop_patience=6)
    assert gen.backend == "plain"
    mel, linear, attn = gen(seq, r=META["r"])
    want = np.load(GOLDEN / "tiny_tacotron_mel.npy")
    assert mel.shape == want.shape == (80, PINNED["frames"])
    np.testing.assert_allclose(mel, want, atol=ATOL)
    assert linear.shape == (cfg.fft_bins, mel.shape[1])
    assert attn.shape == (mel.shape[1] // META["r"], len(seq))
    g = tts_gates(mel, attn, len(seq), gt)
    assert g["attn_monotone"] >= 0.9 and g["attn_coverage"] >= 0.7, g
    assert 0.6 < g["tempo"] < 1.5, g
    assert abs(g["mel_gt_l1"] - PINNED["mel_gt_l1"]) < 0.05, g
    for k in ("attn_monotone", "attn_coverage", "tempo", "frames"):
        assert g[k] == PINNED[k], (k, g[k], PINNED[k])


def test_kernel_backend_on_cpu_passes_the_tts_gate(golden):
    """The kernel backend on the CPU runs the kernel's plain version with
    bf16 weights, in 48-step chunks: the bench's TTS gate must hold."""
    cfg, v, seq, gt = golden
    gen = TTSGenerator(cfg, v, "cpu", steps=400, stop_patience=6,
                       backend="kernel")
    n = cuda_tts.tts_decode.launches
    mel, _, attn = gen(seq, r=META["r"])
    assert cuda_tts.tts_decode.launches == n   # no kernel on the CPU
    g = tts_gates(mel, attn, len(seq), gt)
    assert gates_pass(g, PINNED["mel_gt_l1"]), g
    assert abs(g["frames"] - PINNED["frames"]) <= 8, g


def test_matches_jax_generator(golden, jax_gen):
    """stop_patience=1 (the reference's break at the first quiet group)
    on the eval text: same frames, mel, linear and attention as JAX."""
    cfg, v, seq, _ = golden
    want = jax_gen(seq, r=2)
    got = TTSGenerator(cfg, v, "cpu", steps=400)(seq, r=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_stop_patience_keeps_decoding_through_dips(golden, jax_gen):
    """A longer patience never stops earlier; JAX's frame count at
    patience 1 and the pinned count at patience 6 are both reproduced."""
    cfg, v, seq, _ = golden
    frames = {p: TTSGenerator(cfg, v, "cpu", steps=400, stop_patience=p)(
        seq, r=2)[0].shape[1] for p in (1, 6)}
    assert frames[1] == jax_gen(seq, r=2)[0].shape[1]
    assert frames[6] == PINNED["frames"]
    assert frames[1] <= frames[6]
    with pytest.raises(ValueError, match="stop_patience"):
        TTSGenerator(cfg, v, "cpu", stop_patience=0)


def test_batch_trims_each_utterance_as_jax(golden, jax_gen):
    cfg, v, seq, _ = golden
    seqs = [seq, text_to_sequence("abcde", ["english_cleaners"])]
    want = jax_gen.batch(seqs, r=2)
    got = TTSGenerator(cfg, v, "cpu", steps=400).batch(seqs, r=2)
    assert len(got) == 2
    for (gm, gl, ga), (wm, wl, wa), s in zip(got, want, seqs):
        assert gm.shape == wm.shape and ga.shape == wa.shape
        assert ga.shape[1] == len(s)
        np.testing.assert_allclose(gm, wm, atol=ATOL)
        np.testing.assert_allclose(gl, wl, atol=ATOL)
        np.testing.assert_allclose(ga, wa, atol=ATOL)


def test_generator_refuses_what_it_does_not_take(golden, monkeypatch):
    cfg, v, _, _ = golden
    additive = TacotronConfig(**{**META["dims"], "attn_mode": "additive"})
    with pytest.raises(ValueError, match="location-sensitive"):
        TTSGenerator(additive, v, "cpu", backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        TTSGenerator(cfg, v, "cpu", backend="pallas")
    with pytest.raises(ValueError, match="MeshPlan"):
        TTSGenerator(cfg, v, "cpu", mesh=object())
    world = MeshPlan(n_data=2, devices=(torch.device("cpu"),), world=True)
    with pytest.raises(ValueError, match="local plan"):
        TTSGenerator(cfg, v, "cpu", mesh=world)
    # int8_lstm is taken: the kernel backend packs its LSTM rows as int8
    gen = TTSGenerator(cfg, v, "cpu", backend="kernel", int8_lstm=True)
    assert gen.int8_lstm and gen._packed_for(2)["l1_ih"].dtype == torch.int8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTSGenerator(cfg, v, "cuda")


def test_pipeline_call_and_stream_agree(golden):
    """text -> int16 wav on the CPU, tiny Tacotron into the tiny RAW
    vocoder: ``__call__`` (batched text->mel) and ``stream_synthesize``
    (one text at a time) give each text (frames - 1) * 275 samples, within
    655 LSB of each other for 99% of them (the batched and the single
    decoder sum in other orders; the vocoder is deterministic)."""
    from wavernn_tpu_torch.infer.pipeline import TTSPipeline, mel_from_linear
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig

    cfg, v, seq, _ = golden
    blob = load_pytree(GOLDEN / "tiny_wavernn_raw.msgpack")
    voc_cfg = WaveRNNConfig(rnn_dims=32, fc_dims=32, compute_dims=16,
                            res_out_dims=16, res_blocks=2, mode="RAW")
    pipe = TTSPipeline(cfg, v, voc_cfg, {"params": blob["params"],
                                         "batch_stats": blob["batch_stats"]},
                       ["english_cleaners"], r=2, device="cpu", tts_steps=400,
                       deterministic=True, output_dtype="int16")
    texts = ["abcdeabcde", "edcba"]
    kw = dict(target=1000, overlap=50, mu_law=True)
    one = pipe(texts, **kw)
    stream = list(pipe.stream_synthesize(texts, **kw))
    for t, a, b in zip(texts, one, stream):
        frames = pipe.tts(text_to_sequence(t, ["english_cleaners"]), r=2)[0]
        assert a.dtype == b.dtype == np.int16
        assert a.shape == b.shape == ((frames.shape[1] - 1) * 275,)
        lsb = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert np.mean(lsb <= 655) >= 0.99 and np.std(a) > 0
    assert mel_from_linear(np.array([-5.0, -4.0, 0.0, 4.0, 5.0])).tolist() == [
        0.0, 0.0, 0.5, 1.0, 1.0]
