"""The port's CLIs (``python -m wavernn_tpu_torch.gen_wavernn`` and
``python -m wavernn_tpu_torch.gen_tacotron``) and its WAV writer.

On the CPU the vocoder CLI runs the decode kernel's plain PyTorch version on
the committed tiny RAW golden; the WAV it writes must hold exactly the int16
samples the same ``Generator`` returns.  The TTS CLI runs the tiny Tacotron
golden into the same vocoder; its WAV must parse and hold (frames - 1) *
hop samples.  Without CUDA the default device (``cuda``) must raise rather
than fall back.  The WAV writer must write the bytes the JAX package's
writer writes."""

from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu.dsp import wavio as jax_wavio
from wavernn_tpu_torch import gen_wavernn
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import wavio
from wavernn_tpu_torch.infer.wavernn import make_generator
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
GOLDEN = REPO / "tests" / "golden"
WEIGHTS = GOLDEN / "tiny_wavernn_raw.msgpack"
TINY = dict(voc_rnn_dims=32, voc_fc_dims=32, voc_compute_dims=16,
            voc_res_out_dims=16, voc_res_blocks=2, voc_mode="RAW")


@pytest.fixture()
def cli_args(tmp_path):
    """argv for a 24-frame mel and the tiny RAW golden, with an hp file
    that takes the repository's hparams.py and sets the tiny dims."""
    hp.reset()
    mel_path = tmp_path / "m.npy"
    np.save(mel_path, np.load(GOLDEN / "tiny_wavernn_raw_mel.npy")[:, :24])
    hp_file = tmp_path / "hp_tiny.py"
    hp_file.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        + "".join(f"{k} = {v!r}\n" for k, v in TINY.items()))
    yield ["--file", str(mel_path), "--voc_weights", str(WEIGHTS),
           "--hp_file", str(hp_file), "--output_dir", str(tmp_path / "out"),
           "--target", "1000", "--overlap", "50", "--deterministic"]
    hp.reset()


def test_cli_vocodes_npy_on_cpu(cli_args):
    out = gen_wavernn.main(cli_args + ["--device", "cpu"])
    assert out.name == "__m__0k_steps_gen_batched_target1000_overlap50.wav"
    x, sr = wavio.read_wav_raw(out)
    assert sr == 22050 and x.shape == (23 * 275,)
    blob = load_pytree(WEIGHTS)
    cfg = WaveRNNConfig(rnn_dims=32, fc_dims=32, compute_dims=16,
                        res_out_dims=16, res_blocks=2, mode="RAW")
    gen = make_generator(cfg, {"params": blob["params"],
                               "batch_stats": blob["batch_stats"]},
                         "cpu", deterministic=True)
    want = gen(np.load(cli_args[1]), batched=True, target=1000, overlap=50,
               mu_law=True)
    assert want.dtype == np.int16 and np.std(want) > 0
    np.testing.assert_array_equal(np.round(x * 32768.0).astype(np.int16),
                                  want)


def test_cli_raises_without_cuda(cli_args, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_wavernn.main(cli_args)


def test_cli_refuses_wav_input(cli_args, tmp_path):
    """The CLI once refused a ``.wav``; it now vocodes one (its mel
    through ``dsp/audio.melspectrogram``), writes the input beside the
    result, and still refuses other suffixes."""
    from wavernn_tpu_torch.dsp import audio

    t = np.arange(int(0.3 * 22050)) / 22050
    x = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * np.random.default_rng(
        0).standard_normal(t.shape)).astype(np.float32)
    wav_path = tmp_path / "speech.wav"
    wavio.save_wav(x, wav_path, 22050)
    args = list(cli_args)
    args[1] = str(wav_path)
    out = gen_wavernn.main(args + ["--device", "cpu"])
    assert (out.parent / "__speech__0k_steps_target.wav").exists()
    mel = audio.melspectrogram(audio.load_wav(wav_path))
    got, sr = wavio.read_wav_raw(out)
    assert sr == 22050 and got.shape == ((mel.shape[1] - 1) * 275,)
    blob = load_pytree(WEIGHTS)
    cfg = WaveRNNConfig(rnn_dims=32, fc_dims=32, compute_dims=16,
                        res_out_dims=16, res_blocks=2, mode="RAW")
    gen = make_generator(cfg, {"params": blob["params"],
                               "batch_stats": blob["batch_stats"]},
                         "cpu", deterministic=True)
    want = gen(mel, batched=True, target=1000, overlap=50, mu_law=True)
    np.testing.assert_array_equal(np.round(got * 32768.0).astype(np.int16),
                                  want)
    args[1] = str(tmp_path / "speech.mp3")
    hp.reset()
    with pytest.raises(ValueError, match="Expected .wav or .npy"):
        gen_wavernn.main(args + ["--device", "cpu"])


def test_wav_writer_matches_jax(tmp_path):
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 999).astype(np.float32)
    wavio.save_wav(x, tmp_path / "port.wav", 22050)
    jax_wavio.save_wav(x, tmp_path / "jax.wav", 22050)
    assert ((tmp_path / "port.wav").read_bytes()
            == (tmp_path / "jax.wav").read_bytes())
    pcm = np.array([-32768, -1, 0, 1, 32767], np.int16)
    wavio.save_pcm16(pcm, tmp_path / "pcm.wav", 16000)
    y, sr = wavio.read_wav_raw(tmp_path / "pcm.wav")
    assert sr == 16000
    np.testing.assert_array_equal(np.round(y * 32768.0).astype(np.int16), pcm)


# -- the TTS CLI ----------------------------------------------------------

TACO = GOLDEN / "tiny_tacotron.msgpack"


@pytest.fixture()
def tts_args(tmp_path):
    """argv for the tiny Tacotron golden (r=2 at its 6000 steps) and the
    tiny RAW WaveRNN golden, with an hp file that sets both models' dims."""
    import json

    hp.reset()
    dims = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())["dims"]
    tts = dict(tts_embed_dims=dims["embed_dims"],
               tts_encoder_dims=dims["encoder_dims"],
               tts_decoder_dims=dims["decoder_dims"],
               tts_postnet_dims=dims["postnet_dims"],
               tts_encoder_K=dims["encoder_K"], tts_lstm_dims=dims["lstm_dims"],
               tts_postnet_K=dims["postnet_K"],
               tts_num_highways=dims["num_highways"],
               tts_schedule=[(2, 1e-4, 10_000, 8)])
    hp_file = tmp_path / "hp_tts.py"
    hp_file.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        + "".join(f"{k} = {v!r}\n" for k, v in {**TINY, **tts}.items()))
    yield ["--input_text", "abcdeabcde", "--tts_weights", str(TACO),
           "--hp_file", str(hp_file), "--output_dir", str(tmp_path / "out")]
    hp.reset()


def test_tts_cli_writes_a_wav_on_cpu(tts_args):
    from wavernn_tpu_torch import gen_tacotron
    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.models.tacotron import TacotronConfig
    from wavernn_tpu_torch.text import text_to_sequence
    from wavernn_tpu_torch.text.symbols import symbols

    (out,) = gen_tacotron.main(tts_args + [
        "--device", "cpu", "wavernn", "--voc_weights", str(WEIGHTS),
        "--target", "1000", "--overlap", "50"])
    assert out.name == "__input_abcdeabcde_wavernn_batched_6k.wav"
    x, sr = wavio.read_wav_raw(out)
    cfg = TacotronConfig.from_hp(hp, num_chars=len(symbols))
    blob = load_pytree(TACO)
    mel, _, _ = TTSGenerator(cfg, {"params": blob["params"],
                                   "batch_stats": blob["batch_stats"]},
                             "cpu")(text_to_sequence("abcdeabcde",
                                                     ["english_cleaners"]), r=2)
    assert sr == 22050 and x.shape == ((mel.shape[1] - 1) * 275,)
    assert np.std(x) > 0


def test_tts_cli_refuses_what_is_not_ported(tts_args, monkeypatch):
    """``--int8`` and ``--no_int8`` together are refused (they exclude each
    other, as in the JAX CLI); a mesh that does not start on
    ``--device``, or ``--mesh_devices`` without ``--mesh``, is a wrong
    plan; without CUDA the default device raises."""
    from wavernn_tpu_torch import gen_tacotron

    voc = ["wavernn", "--voc_weights", str(WEIGHTS)]
    hp.reset()
    with pytest.raises(SystemExit):
        gen_tacotron.main(tts_args + ["--device", "cpu", "--int8",
                                      "--no_int8"] + voc)
    for extra, what in ((["--mesh_devices", "cpu,cpu"], "needs --mesh"),
                        (["--mesh", "--mesh_devices", "meta,cpu"],
                         "first device")):
        hp.reset()
        with pytest.raises(ValueError, match=what):
            gen_tacotron.main(tts_args + ["--device", "cpu"] + extra + voc)
    hp.reset()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_tacotron.main(tts_args + voc)


def test_cli_mesh_vocodes_as_without(cli_args):
    """``--mesh --mesh_devices cpu,cpu`` splits every launch's fold rows
    over two shards and writes the meshless CLI's WAV byte for byte
    (sampling: each shard draws its rows' bits)."""
    args = [a for a in cli_args if a != "--deterministic"] + [
        "--device", "cpu", "--seed", "5"]
    plain = gen_wavernn.main(args).read_bytes()
    hp.reset()
    out_dir = args.index("--output_dir") + 1
    args[out_dir] += "_mesh"
    meshed = gen_wavernn.main(args + ["--mesh", "--mesh_devices", "cpu,cpu"])
    assert meshed.read_bytes() == plain


def test_cli_mesh_with_a_model_axis_vocodes_as_without(cli_args):
    """``hp.mesh_shape = {"data": 2, "model": 2}`` over four devices, as
    the JAX CLI takes it: the fold rows split over the data axis, and the
    WAV is the meshless one byte for byte."""
    args = [a for a in cli_args if a != "--deterministic"] + [
        "--device", "cpu", "--seed", "5"]
    plain = gen_wavernn.main(args).read_bytes()
    hp.reset()
    hp_file = Path(args[args.index("--hp_file") + 1])
    hp_file.write_text(hp_file.read_text()
                       + "mesh_shape = {'data': 2, 'model': 2}\n")
    args[args.index("--output_dir") + 1] += "_mesh"
    meshed = gen_wavernn.main(args + ["--mesh", "--mesh_devices",
                                      "cpu,cpu,cpu,cpu"])
    assert meshed.read_bytes() == plain


def test_tts_cli_mesh_vocodes_as_without(tts_args):
    """``gen_tacotron --mesh`` shards the vocoder's fold rows: the WAV is
    the meshless one byte for byte."""
    from wavernn_tpu_torch import gen_tacotron

    voc = ["wavernn", "--voc_weights", str(WEIGHTS), "--target", "400",
           "--overlap", "50"]
    (plain,) = gen_tacotron.main(tts_args + ["--device", "cpu"] + voc)
    want = plain.read_bytes()
    hp.reset()
    args = list(tts_args)
    args[args.index("--output_dir") + 1] += "_mesh"
    (meshed,) = gen_tacotron.main(args + [
        "--device", "cpu", "--mesh", "--mesh_devices", "cpu,cpu"] + voc)
    assert meshed.name == plain.name and meshed.read_bytes() == want


def test_tts_cli_griffinlim_writes_a_wav_on_cpu(tts_args):
    """The griffinlim vocoder (``dsp/torch_audio.reconstruct_waveform``):
    a float WAV of (frames - 1) * hop finite, non-silent samples."""
    from wavernn_tpu_torch import gen_tacotron

    (out,) = gen_tacotron.main(tts_args + ["--device", "cpu", "griffinlim",
                                           "--iters", "4"])
    assert out.name == "__input_abcdeabcde_griffinlim_6k.wav"
    x, sr = wavio.read_wav_raw(out)
    assert sr == 22050 and x.size > 0 and x.size % 275 == 0
    assert np.isfinite(x).all() and np.std(x) > 0
