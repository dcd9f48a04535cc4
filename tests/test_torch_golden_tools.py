"""The port's ``train_golden`` (``wavernn_tpu_torch/tools/train_golden.py``)
against the JAX tool (``tools/train_golden.py``, imported by path) and the
committed pins, on the CPU.

The copied corpora (the harmonic and speech-shaped signals, the note
corpus's texts, tones and waves) and the batch sampler's draws equal the
JAX tool's byte for byte.  ``--which taco-pin`` on the committed tiny
Tacotron gives the committed mel and attention within 1e-3 (the tolerance
of ``tests/test_torch_tts_generator.py``) and the committed gates at their
rounding (``mel_gt_l1`` within one unit of its fourth decimal).  ``--out``
inside ``tests/golden`` or ``bench_assets`` raises.  ``--which tiny`` at a
few steps writes a msgpack with the leaf names, shapes and dtypes of
``tests/golden/tiny_wavernn_raw.msgpack``.
"""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from wavernn_tpu_torch.tools import train_golden
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
GOLDEN = REPO / "tests" / "golden"
SR = 22050


def jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tg():
    return jax_tool("train_golden")


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            a = np.asarray(v)
            yield "/".join(prefix + (k,)), a.shape, a.dtype


def test_signals_equal_the_jax_tools(jax_tg):
    for got, want in (
            (train_golden.harmonic_signal(SR, 3.0),
             jax_tg.harmonic_signal(SR, 3.0)),
            (train_golden.speech_signal(SR, 4.0),
             jax_tg.speech_signal(SR, 4.0)),
            (train_golden.speech_signal(SR, 2.0, seed=5),
             jax_tg.speech_signal(SR, 2.0, seed=5))):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_note_corpus_equals_the_jax_tools(jax_tg):
    texts = train_golden.taco_corpus_texts()
    assert texts == jax_tg._taco_corpus_texts() and len(texts) == 1103
    tones = train_golden.taco_tones(texts)
    assert tones == jax_tg._taco_tones(texts)
    assert train_golden.TACO_DIMS == jax_tg.TACO_DIMS
    from wavernn_tpu.text import text_to_sequence

    for text in texts[:4]:
        seq = text_to_sequence(text, train_golden.CLEANERS)
        got = train_golden.taco_wav(seq, tones, SR)
        assert got.tobytes() == jax_tg._taco_wav(seq, tones, SR).tobytes()


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_batch_draws_equal_the_jax_tools(jax_tg, mode, monkeypatch):
    """The JAX tool's ``train`` with its model and step stubbed: its
    batches, recorded, against the port's sampler on the same inputs."""
    import wavernn_tpu.models.wavernn as jax_wavernn
    import wavernn_tpu.training.state as jax_state
    import wavernn_tpu.training.wavernn as jax_training

    drawn = []

    def make_train_step(model, opt, mode, donate):
        def step(state, x, t, m):
            drawn.append((x, t, m))
            return state, 0.0, None
        return step

    monkeypatch.setattr(jax_wavernn, "WaveRNN", lambda cfg: SimpleNamespace(
        init=lambda *a: {"params": {}, "batch_stats": {}}))
    monkeypatch.setattr(jax_state, "make_optimizer", lambda lr, clip: None)
    monkeypatch.setattr(jax_state, "new_train_state", lambda *a: None)
    monkeypatch.setattr(jax_training, "make_train_step", make_train_step)

    rng = np.random.default_rng(4)
    mel = rng.uniform(0, 1, (80, 120)).astype(np.float32)
    y = rng.uniform(-1, 1, 120 * 275).astype(np.float32)
    labels = rng.integers(0, 512, y.shape).astype(np.int64)
    cfg = SimpleNamespace(mode=mode, bits=9, feat_dims=80)
    jax_tg.train(cfg, mel, y, labels, steps=3, batch_size=5, seq_len=1375,
                 lr=1e-3, clip=4.0, pad=2, hop=275)
    batch = train_golden.batches(mel, y, labels, mode, 5, 1375, 2, 275, 9)
    assert len(drawn) == 3
    for want in drawn:
        got = batch()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


def test_taco_pin_matches_the_committed_pins(tmp_path, capsys):
    rec = train_golden.main(["--which", "taco-pin", "--from", str(GOLDEN),
                             "--out", str(tmp_path), "--device", "cpu"])
    assert last_json(capsys) == rec
    pinned = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())
    want = pinned["pinned_gates_cpu_xla"]
    for name in ("mel", "attn"):
        got = np.load(tmp_path / f"tiny_tacotron_{name}.npy")
        ref = np.load(GOLDEN / f"tiny_tacotron_{name}.npy")
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-3)
    for k, v in want.items():
        if k == "mel_gt_l1":
            assert abs(rec[k] - v) <= 1e-4, (k, rec[k], v)
        else:
            assert rec[k] == v, (k, rec[k], v)
    meta = json.loads((tmp_path / "tiny_tacotron_meta.json").read_text())
    assert meta["pinned_gates_cpu_xla"] == {k: rec[k] for k in want}
    assert {k: meta[k] for k in ("dims", "eval_text", "r")} == {
        k: pinned[k] for k in ("dims", "eval_text", "r")}


@pytest.mark.parametrize("out", ["tests/golden", "tests/golden/new",
                                 "bench_assets"])
def test_out_refuses_the_pinned_directories(out):
    before = sorted(p.name for p in (REPO / out).parent.iterdir())
    with pytest.raises(ValueError, match="pins"):
        train_golden.main(["--which", "taco-pin", "--out",
                           str(REPO / out), "--device", "cpu"])
    assert sorted(p.name for p in (REPO / out).parent.iterdir()) == before


def test_run_tiny_writes_the_golden_layout(tmp_path, capsys):
    rec = train_golden.main(["--which", "tiny", "--steps", "2", "--out",
                             str(tmp_path), "--device", "cpu"])
    assert last_json(capsys) == rec
    assert all(np.isfinite(rec[k]) for k in (
        "final_loss", "cpu_host_train_seconds", "wav_std"))
    got = sorted(leaves(load_pytree(tmp_path / "tiny_wavernn_raw.msgpack")))
    want = sorted(leaves(load_pytree(GOLDEN / "tiny_wavernn_raw.msgpack")))
    assert got == want
    for name in ("wav", "mel"):
        a = np.load(tmp_path / f"tiny_wavernn_raw_{name}.npy")
        b = np.load(GOLDEN / f"tiny_wavernn_raw_{name}.npy")
        assert a.shape == b.shape and a.dtype == b.dtype
    assert rec["wav_len"] == 119 * 275
