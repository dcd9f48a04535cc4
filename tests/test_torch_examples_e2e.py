"""The port's end-to-end TTS example (``wavernn_tpu_torch/examples/
e2e_tts.py``) against the JAX example (``examples/e2e_tts.py``).

Targets: ``TRAIN_TEXTS``, ``EVAL_TEXTS`` and the symbol -> tone map equal
to JAX's; the WAVs (and metadata) ``build_corpus`` writes for the first 16
texts byte-equal to JAX's (its text list cut to them, its tone map the
full corpus's); ``diagonality``, ``dominant_freq`` and ``spectral_match``
within 1e-12 of JAX's on seeded attention matrices and WAVs;
``measure_gates`` equal to the gates the JAX ``evaluate_gates`` prints,
and the same pass / fail at the thresholds 0.85 / 0.7 / 0.4 / 0.6.  On the
CPU, ``main --gates_only`` reads a workspace, and the four CLIs run in
process at tiny widths leave ``hp`` cleared."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import wavio
from wavernn_tpu_torch.examples import e2e_tts
from tests.jax_examples import jax_example
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ex():
    return jax_example("e2e_tts")


def test_texts_and_tones_equal_jax(ex):
    assert e2e_tts.TRAIN_TEXTS == ex.TRAIN_TEXTS
    assert len(e2e_tts.TRAIN_TEXTS) == 1200
    assert e2e_tts.EVAL_TEXTS == ex.EVAL_TEXTS
    assert e2e_tts._symbol_tones() == ex._symbol_tones()
    def settings(template):
        return [line for line in template.splitlines()
                if line and not line.startswith("#")]
    assert settings(e2e_tts.HP_TEMPLATE) == settings(ex.HP_TEMPLATE)


def test_corpus_prefix_byte_equal_to_jax(ex, tmp_path, monkeypatch):
    tones = ex._symbol_tones()
    monkeypatch.setattr(ex, "_symbol_tones", lambda: tones)
    monkeypatch.setattr(ex, "TRAIN_TEXTS", ex.TRAIN_TEXTS[:16])
    ex.build_corpus(tmp_path / "jax")
    e2e_tts.build_corpus(tmp_path / "port", e2e_tts.TRAIN_TEXTS[:16])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 17 and "metadata.csv" in names
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes()), n


def attention(rng, steps, L, diagonal):
    a = rng.uniform(0, 1, (steps, L)) ** 4
    if diagonal:
        a[np.arange(steps), np.minimum(np.arange(steps) * L // steps,
                                       L - 1)] += 3
    return a / a.sum(1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_functions_match_jax(ex, seed):
    rng = np.random.default_rng(seed)
    tones = e2e_tts._symbol_tones()
    for diagonal in (True, False):
        a = attention(rng, 40, 12, diagonal)
        np.testing.assert_allclose(e2e_tts.diagonality(a, 12),
                                   ex.diagonality(a, 12), rtol=0, atol=1e-12)
    seq = e2e_tts._seq(e2e_tts.EVAL_TEXTS[seed])
    n = int(e2e_tts.NOTE_SECONDS * e2e_tts.SR)
    wav = np.concatenate([np.sin(2 * np.pi * tones[s] * np.arange(n)
                                 / e2e_tts.SR) for s in seq])
    wav = wav + 0.3 * rng.standard_normal(len(wav))
    for seg in (wav[:n], wav[n:3 * n], wav[:n // 2 + 7]):
        assert abs(e2e_tts.dominant_freq(seg) - ex.dominant_freq(seg)) <= 1e-12
    got = e2e_tts.spectral_match(wav, seq, tones)
    assert abs(got - ex.spectral_match(wav, seq, tones)) <= 1e-12
    assert got > 0.6


def workspace(ws, tts_id, diagonal):
    """Gate artifacts for the EVAL_TEXTS: attention and the corpus WAV of
    each text, named as ``gen_tacotron --save_attention`` names them."""
    out = ws / "model_outputs" / f"{tts_id}.tacotron"
    e2e_tts.build_corpus(ws / "wavs", e2e_tts.EVAL_TEXTS)
    rng = np.random.default_rng(3)
    out.mkdir(parents=True)
    for i, text in enumerate(e2e_tts.EVAL_TEXTS, 1):
        L = len(e2e_tts._seq(text))
        stem = f"{i}_wavernn_batched_0k"
        np.save(out / f"{stem}_attention.npy",
                attention(rng, 3 * L, L, diagonal))
        pcm = (wavio.load_wav(ws / "wavs" / f"utt{i - 1}.wav", sr=22050)
               * 32767).astype(np.int16)
        wavio.save_pcm16(pcm, out / f"{stem}.wav", 22050)


@pytest.mark.parametrize("diagonal", [True, False])
def test_measure_gates_match_jax_evaluate_gates(ex, tmp_path, capsys,
                                                diagonal):
    workspace(tmp_path, "tts", diagonal)
    args = SimpleNamespace(keep=True, workspace=str(tmp_path))
    if diagonal:
        ex.evaluate_gates(tmp_path, args)
    else:
        with pytest.raises(SystemExit):
            ex.evaluate_gates(tmp_path, args)
    want = json.loads(capsys.readouterr().out.splitlines()[0])
    got = e2e_tts.measure_gates(tmp_path)
    assert got == want
    assert e2e_tts.gates_pass(got) is diagonal


def test_main_gates_only_on_cpu(tmp_path, capsys):
    workspace(tmp_path, "tts", True)
    gates = e2e_tts.main(["--gates_only", "--workspace", str(tmp_path)])
    out = capsys.readouterr().out
    assert "E2E TTS gates PASSED" in out and gates["min_spectral"] > 0.6
    assert tmp_path.exists()    # --workspace given: kept


TINY = """
tts_embed_dims = 16
tts_encoder_dims = 16
tts_decoder_dims = 32
tts_postnet_dims = 16
tts_encoder_K = 4
tts_lstm_dims = 32
tts_postnet_K = 3
tts_num_highways = 2
voc_rnn_dims = 32
voc_fc_dims = 32
voc_compute_dims = 16
voc_res_out_dims = 16
voc_res_blocks = 1
voc_batch_size = 2
voc_seq_len = 550
voc_target = 200
voc_overlap = 28
"""


def test_cli_chain_in_process_leaves_hp_clear(tmp_path, monkeypatch):
    """The four CLIs on 12 texts at tiny widths (2 Tacotron and 2 vocoder
    steps, a 64-frame decode cap): GTA mels, both checkpoints and the
    three WAVs with their attention; ``hp`` is cleared after each."""
    from wavernn_tpu_torch.infer import tacotron

    monkeypatch.setattr(e2e_tts, "HP_TEMPLATE",
                        e2e_tts.HP_TEMPLATE + TINY)
    init = tacotron.TTSGenerator.__init__
    monkeypatch.setattr(tacotron.TTSGenerator, "__init__",
                        lambda self, *a, **k: init(self, *a,
                                                   **{**k, "steps": 64}))
    configured = []
    run_cli = e2e_tts.run_cli

    def checked(main, argv, cwd, tag):
        out = run_cli(main, argv, cwd, tag)
        configured.append(hp.is_configured())
        return out
    monkeypatch.setattr(e2e_tts, "run_cli", checked)
    e2e_tts.run_pipeline(tmp_path, 2, 2, "cpu", e2e_tts.TRAIN_TEXTS[:12],
                         num_workers=1)
    assert configured == [False] * 4
    gta = list((tmp_path / "data" / "gta").glob("*.npy"))
    assert len(gta) == 12
    gates = e2e_tts.measure_gates(tmp_path)
    assert len(gates["utterances"]) == 3
    assert all(0 < u["audio_s"] for u in gates["utterances"])


def test_main_fails_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        e2e_tts.main(["--workspace", str(tmp_path)])
    assert not list(tmp_path.iterdir())
