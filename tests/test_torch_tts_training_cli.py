"""The port's Tacotron training chain through its CLIs, in process on the
CPU (``--device cpu``), at ``tests/test_tacotron.py``'s tiny Tacotron
sizes: preprocess a seeded six-utterance corpus of word texts paired with
tones, ``train_tacotron`` through a two-session curriculum (r = 3 then 2,
three steps each) with its checkpoints, plots and GTA export, a re-run that
resumes in the session the stored step selects, then ``gen_wavernn`` on
the test set, with ``--eval`` and with ``--gta`` (the committed tiny RAW
vocoder golden), and ``gen_tacotron --save_attention`` (the committed tiny
Tacotron golden, which stops by itself).  Without ``--device`` the trainer
asks for CUDA, and on a machine without it raises."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu_torch import gen_tacotron, gen_wavernn, preprocess
from wavernn_tpu_torch import train_tacotron
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import wavio
from wavernn_tpu_torch.utils import display
from wavernn_tpu_torch.utils.checkpoints import load_pytree

REPO = Path(__file__).parent.parent
GOLDEN = REPO / "tests" / "golden"
WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog"]
N_UTTS, N_SAMPLES = 6, 1375          # 5 hops: 6 mel frames each
HP = f"""import runpy
globals().update({{k: v for k, v in runpy.run_path({str(REPO / "hparams.py")!r}).items()
                  if not k.startswith("__")}})
wav_path = "wavs"; data_path = "data"
voc_mode = "RAW"; voc_rnn_dims = 32; voc_fc_dims = 32
voc_compute_dims = 16; voc_res_out_dims = 16; voc_res_blocks = 2
voc_test_samples = 2; voc_gen_at_checkpoint = 1
voc_target = 550; voc_overlap = 110
tts_embed_dims = 16; tts_encoder_dims = 16; tts_decoder_dims = 32
tts_postnet_dims = 16; tts_encoder_K = 4; tts_lstm_dims = 32
tts_postnet_K = 3; tts_num_highways = 2
tts_checkpoint_every = 2; latest_save_min_interval_s = 0.0
tts_schedule = SCHEDULE
"""
# three batches of two an epoch: each session runs a whole epoch, so the
# attention example (the longest utterance) comes by
SESSIONS = [(3, 1e-3, 3, 2), (2, 5e-4, 6, 2)]
TTS_DIR = Path("checkpoints") / "ljspeech_lsa_smooth_attention.tacotron"


def write_hp(ws: Path, schedule) -> Path:
    (ws / "hp.py").write_text(HP.replace("SCHEDULE", repr(schedule)))
    return ws / "hp.py"


def call(main, argv):
    hp.reset()
    try:
        return main(argv)
    finally:
        hp.reset()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The workspace after preprocessing and a first curriculum run; the
    first run's standard output."""
    ws = tmp_path_factory.mktemp("tts_cli")
    mp = pytest.MonkeyPatch()
    mp.chdir(ws)
    (ws / "wavs").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(N_UTTS):
        t = np.arange(N_SAMPLES) / 22050
        y = 0.4 * np.sin(2 * np.pi * 220 * (i + 1) * t)
        wavio.save_wav(y.astype(np.float32), ws / "wavs" / f"utt{i}.wav",
                       22050)
        text = " ".join(rng.choice(WORDS, int(rng.integers(2, 5))))
        lines.append(f"utt{i}|{text}|{text}")
    (ws / "wavs" / "metadata.csv").write_text("\n".join(lines))
    hp_file = write_hp(ws, SESSIONS)
    call(preprocess.main, ["--path", "wavs", "--hp_file", str(hp_file),
                           "--num_workers", "1"])
    state = call(train_tacotron.main, ["--hp_file", str(hp_file),
                                       "--device", "cpu"])
    yield ws, state
    mp.undo()


def test_train_tacotron_trains_the_curriculum_and_writes_gta(trained):
    ws, state = trained
    assert state.step == 6
    assert state.opt_state.learning_rate == float(np.float32(5e-4))
    ckpt = ws / TTS_DIR
    for name, step in (("latest", 6), ("taco_step0K", 6)):
        assert int(load_pytree(ckpt / f"{name}_weights.msgpack")["step"]) \
            == step
        assert (ckpt / f"{name}_optim.msgpack").exists()
    for sub in ("attention", "mel_plots"):
        assert any((ckpt / sub).iterdir()), sub
    assert "Loss:" in (ckpt / "log.txt").read_text()
    for i in range(N_UTTS):
        gta = np.load(ws / "data" / "gta" / f"utt{i}.npy")
        mel = np.load(ws / "data" / "mel" / f"utt{i}.npy")
        assert gta.shape == mel.shape and gta.dtype == np.float32
        assert np.isfinite(gta).all()


def test_train_tacotron_resumes_in_the_stored_session(trained, capsys):
    ws, _ = trained
    hp_file = write_hp(ws, SESSIONS + [(2, 2.5e-4, 7, 2)])
    capsys.readouterr()
    state = call(train_tacotron.main, ["--hp_file", str(hp_file),
                                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Restoring from latest checkpoint" in out
    assert "Steps with r=2" in out and "Steps with r=3" not in out
    assert "0.00025" in out
    assert state.step == 7
    assert state.opt_state.learning_rate == float(np.float32(2.5e-4))
    assert state.opt_state.count == 7
    latest = ws / TTS_DIR / "latest_weights.msgpack"
    assert int(load_pytree(latest)["step"]) == 7
    # --force_gta: no training, the GTA export only
    state = call(train_tacotron.main, ["--hp_file", str(hp_file),
                                       "--device", "cpu", "--force_gta"])
    assert state.step == 7


@pytest.mark.parametrize("mode", ["testset", "eval", "gta"])
def test_gen_wavernn_test_set_paths(trained, mode, capsys):
    ws, _ = trained
    argv = ["--hp_file", str(ws / "hp.py"), "--device", "cpu",
            "--voc_weights", str(GOLDEN / "tiny_wavernn_raw.msgpack"),
            "--samples", "1", "--output_dir", f"gen_{mode}"]
    extra = {"testset": [], "eval": ["--eval"], "gta": ["--gta"]}[mode]
    out = call(gen_wavernn.main, argv + extra)
    if mode == "eval":
        assert len(out) == 1 and np.isfinite(out[0])
        assert "copy-synthesis MCD" in capsys.readouterr().out
        return
    (wav,) = out
    x, sr = wavio.read_wav_raw(wav)
    assert sr == 22050 and x.shape == (N_SAMPLES,) and np.std(x) > 0
    assert (ws / f"gen_{mode}" / "0k_steps_1_target.wav").exists()


def test_gen_tacotron_saves_attention(trained, tmp_path):
    import json

    dims = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())["dims"]
    hp_file = tmp_path / "hp_golden.py"
    hp_file.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        + "".join(f"tts_{k} = {v!r}\n" for k, v in dims.items()
                  if k not in ("num_chars", "n_mels", "fft_bins", "dropout",
                               "stop_threshold", "attn_mode"))
        + "tts_schedule = [(2, 1e-4, 10_000, 8)]\n")
    (out,) = call(gen_tacotron.main, [
        "--input_text", "abcdeabcde", "--tts_weights",
        str(GOLDEN / "tiny_tacotron.msgpack"), "--hp_file", str(hp_file),
        "--output_dir", str(tmp_path / "out"), "--device", "cpu",
        "--save_attention", "griffinlim", "--iters", "2"])
    attn = np.load(out.parent / f"{out.stem}_attention.npy")
    assert attn.shape[0] > 10 and attn.shape[1] == 10   # (frames / r, text)
    assert np.isfinite(attn).all() and attn.min() >= 0 and attn.max() <= 1
    if display._pyplot() is not None:
        png = out.parent / f"{out.stem}.png"
        assert png.read_bytes()[:4] == b"\x89PNG"


def test_train_tacotron_without_device_needs_cuda(trained, monkeypatch):
    ws, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(train_tacotron.main, ["--hp_file", str(ws / "hp.py")])
