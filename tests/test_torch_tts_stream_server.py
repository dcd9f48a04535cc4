"""The port's two-stage ``TTSStreamServer`` (text -> mel -> co-batched
vocoder streams), against its own solo two-stage streams and the JAX
package's server (mirrors the ``TTSStreamServer`` cases of
``tests/test_stream_server.py``).

Models: the committed tiny golden Tacotron (r=2, plain decoder on the CPU)
and the committed tiny RAW golden WaveRNN, target 200 / overlap 28,
deterministic decode.  Tolerances: each session within 1e-5 of its solo
stream (the JAX test's), int16 sessions byte-equal to theirs.  The port
against the JAX server (both float32: the port's scan backend and plain
Tacotron decoder, JAX's scan and XLA decoder): at least 99% of int16
samples within 655 LSB, the rate ``test_torch_stream_server.py`` holds the
vocoder server to, and for its reason on the vocoder of that test (the
small seeded MOL model, whose deterministic sample is a mixture mean): the
tiny RAW golden's 512-way argmax has near-ties that float32 rounding
flips, by up to 42 labels at isolated samples (98.9% of "abcde" within
655 LSB on the same mel), while the two Tacotron decoders' mels agree to
3e-6.  So the tiny RAW golden's pairing is held stage by stage: the
serving mels within 1e-5, the sessions at least 95% within 655 LSB."""

import json
from pathlib import Path

import numpy as np
import pytest

from wavernn_tpu_torch.infer.pipeline import TTSPipeline, mel_from_linear
from wavernn_tpu_torch.infer.stream_server import TTSStreamServer
from wavernn_tpu_torch.models.tacotron import TacotronConfig
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.text import text_to_sequence
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.test_torch_stream import OVERLAP, TARGET, agreement, small
from tests.torch_cpu import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
META = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())
VOC = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
           res_blocks=2, mode="RAW")
TEXTS = ["abcde", "edcba", "abcdea"]
SERVE = dict(target=TARGET, overlap=OVERLAP, mu_law=True)


def variables(name):
    blob = load_pytree(GOLDEN / name)
    return {"params": blob["params"], "batch_stats": blob["batch_stats"]}


def tiny_pipeline(**kw) -> TTSPipeline:
    """The tiny golden Tacotron into the tiny RAW golden on the CPU,
    deterministic (kernel backend: the decode kernel's plain version)."""
    kw = {"tts_steps": 400, "deterministic": True, **kw}
    return TTSPipeline(TacotronConfig(**META["dims"]),
                       variables("tiny_tacotron.msgpack"),
                       WaveRNNConfig(**VOC),
                       variables("tiny_wavernn_raw.msgpack"),
                       ["english_cleaners"], r=META["r"], device="cpu", **kw)


def solo_two_stage(pipe, text, group):
    _, m_linear, _ = pipe.tts(text_to_sequence(text, ["english_cleaners"]),
                              r=pipe.r)
    return np.concatenate(list(pipe.voc.stream(mel_from_linear(m_linear),
                                               group=group, **SERVE)))


def test_tts_server_matches_solo_two_stage_streams():
    """Three concurrent sessions give each text's own two-stage stream, in
    fewer vocoder launches than the solo streams."""
    pipe = tiny_pipeline()
    want = [solo_two_stage(pipe, t, group=16) for t in TEXTS]
    srv = TTSStreamServer(pipe, group=16, width=48, capacity=2,
                          slot_seconds=2.0, **SERVE)
    got = srv.run(TEXTS)
    spans = sum(-(-len(w) // (TARGET + OVERLAP) // 16) for w in want)
    assert 0 < srv.server.launches < spans
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64 and len(g) > 1000
        np.testing.assert_allclose(g, w, atol=1e-5)
    assert srv.active == [] and srv.active_count == 0


def test_tts_server_matches_jax_server():
    from wavernn_tpu.infer.pipeline import TTSPipeline as JaxPipeline
    from wavernn_tpu.infer.stream_server import TTSStreamServer as JaxServer
    from wavernn_tpu.models.tacotron import TacotronConfig as JaxTaco
    from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxVoc

    k, v = small("MOL")
    kw = dict(group=16, width=64, capacity=4, **SERVE)
    texts = TEXTS[:2]
    jax_pipe = JaxPipeline(
        JaxTaco(**META["dims"]), variables("tiny_tacotron.msgpack"),
        JaxVoc(**k), v, ["english_cleaners"], r=META["r"], backend="scan",
        tts_steps=400, tts_backend="xla", deterministic=True,
        output_dtype="int16")
    jax_srv = JaxServer(jax_pipe, **kw)
    want = jax_srv.run(texts)
    pipe = TTSPipeline(TacotronConfig(**META["dims"]),
                       variables("tiny_tacotron.msgpack"), WaveRNNConfig(**k),
                       v, ["english_cleaners"], r=META["r"], device="cpu",
                       backend="scan", tts_backend="plain", tts_steps=400,
                       deterministic=True, output_dtype="int16")
    srv = TTSStreamServer(pipe, **kw)
    got = srv.run(texts)
    assert srv.server.launches == jax_srv.server.launches
    for g, w in zip(got, want):
        assert len(g) > 1000
        assert agreement(g, w) >= 0.99


def test_tts_server_matches_jax_server_on_the_raw_golden():
    """The named pairing, the tiny golden Tacotron into the tiny RAW
    golden, against the JAX server stage by stage: each text's serving mel
    within 1e-5 of JAX's, and each int16 session at least 95% within 655
    LSB of JAX's, the rate ``test_torch_stream.py`` holds a stream to where
    the 512-way argmax's near-ties flip on rounding."""
    from wavernn_tpu.infer.pipeline import TTSPipeline as JaxPipeline
    from wavernn_tpu.infer.pipeline import mel_from_linear as jax_mel
    from wavernn_tpu.infer.stream_server import TTSStreamServer as JaxServer
    from wavernn_tpu.models.tacotron import TacotronConfig as JaxTaco
    from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxVoc

    kw = dict(group=16, width=64, capacity=4, **SERVE)
    texts = TEXTS[:2]
    jax_pipe = JaxPipeline(
        JaxTaco(**META["dims"]), variables("tiny_tacotron.msgpack"),
        JaxVoc(**VOC), variables("tiny_wavernn_raw.msgpack"),
        ["english_cleaners"], r=META["r"], backend="scan", tts_steps=400,
        tts_backend="xla", deterministic=True, output_dtype="int16")
    pipe = tiny_pipeline(backend="scan", tts_backend="plain",
                         output_dtype="int16")
    for t in texts:
        seq = text_to_sequence(t, ["english_cleaners"])
        want = jax_mel(jax_pipe.tts.collect(jax_pipe.tts.submit(
            seq, r=META["r"]))[1])
        got = mel_from_linear(pipe.tts.collect(pipe.tts.submit(
            seq, r=META["r"]))[1])
        assert got.shape == want.shape and got.shape[1] > 10
        np.testing.assert_allclose(got, want, atol=1e-5)
    jax_srv = JaxServer(jax_pipe, **kw)
    want = jax_srv.run(texts)
    srv = TTSStreamServer(pipe, **kw)
    got = srv.run(texts)
    assert srv.server.launches == jax_srv.server.launches
    for g, w in zip(got, want):
        assert len(g) > 1000
        assert agreement(g, w) >= 0.95


def test_tts_server_routes_admission_failure_to_its_session(monkeypatch):
    """A vocoder admission failure is that session's terminal result (an
    ``Exception`` value), not silent audio, and the other session
    completes; ``run`` raises it."""
    srv = TTSStreamServer(tiny_pipeline(), group=16, width=48, capacity=2,
                          slot_seconds=2.0, **SERVE)
    boom = ValueError("utterance needs 99 conditioning rows but the slot "
                      "holds 1")
    healthy_add = srv.server.add
    calls = {"n": 0}

    def add(mel):
        calls["n"] += 1
        if calls["n"] in (2, 3):
            raise boom
        return healthy_add(mel)

    monkeypatch.setattr(srv.server, "add", add)
    ok_sid, bad_sid = srv.add("abcde"), srv.add("edcba")
    out, pieces = {}, []
    while srv.active:
        for sid, chunk in srv.step().items():
            if sid == ok_sid and not isinstance(chunk, Exception):
                pieces.append(chunk)
            else:
                out[sid] = chunk
    assert out[bad_sid] is boom
    assert bad_sid not in srv.active
    assert len(np.concatenate(pieces)) > 0
    with pytest.raises(ValueError, match="slot"):
        srv.run(["abcde"])


def test_tts_server_int16_chunks_and_the_sub_hop_rule(monkeypatch):
    """An int16 pipeline serves int16 chunks; a mel of fewer than 2 frames
    completes with one empty chunk of the serving dtype."""
    pipe = tiny_pipeline(output_dtype="int16")
    srv = TTSStreamServer(pipe, group=16, width=48, capacity=2,
                          slot_seconds=2.0, **SERVE)
    waves = srv.run(TEXTS[:2])
    for w, t in zip(waves, TEXTS):
        assert w.dtype == np.int16 and np.abs(w.astype(np.int32)).max() > 0
        np.testing.assert_array_equal(w, solo_two_stage(pipe, t, group=16))

    collect = pipe.tts.collect

    def one_frame(handle):
        mel, linear, attn = collect(handle)
        return mel[:, :1], linear[:, :1], attn[:1]

    monkeypatch.setattr(pipe.tts, "collect", one_frame)
    sid = srv.add("abcde")
    out = srv.step()
    assert list(out) == [sid] and out[sid].dtype == np.int16
    assert out[sid].shape == (0,) and srv.active == []
    assert srv.run(["abcde"])[0].shape == (0,)
