"""``python -m wavernn_tpu_torch.quick_start`` against the JAX package's
``quick_start.py``, on the CPU.

The committed tiny goldens (the RAW WaveRNN and the Tacotron) are zipped
into ``pretrained/`` under the reference's archive names, beside an hp file
with their dims.  Both programs run in process from that directory, each
with its vocoder replaced by a recorder (and JAX's weights read straight
from the file, without the init that builds its template state): the
printed table and the WAV names must be JAX's, and the mel each hands its
vocoder must equal JAX's ``TTSGenerator`` mel within 1e-3 (the TTS tests'
tolerance), for ``-i`` batched and for ``sentences.txt`` unbatched.  The
port's run end to end is ``tests/test_torch_quick_start_cpu.py``.
"""

import importlib.util
import json
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from wavernn_tpu_torch import quick_start
from wavernn_tpu_torch.config import hp
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
GOLDEN = REPO / "tests" / "golden"
META = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())
TINY_VOC = dict(voc_rnn_dims=32, voc_fc_dims=32, voc_compute_dims=16,
                voc_res_out_dims=16, voc_res_blocks=2, voc_mode="RAW")


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """A working directory with the pretrained zips, an hp file with the
    goldens' dims (r = 2 at the Tacotron's step) and a sentences.txt."""
    (tmp_path / "pretrained").mkdir()
    for zip_name, weights in (
            (quick_start.VOC_ZIP, "tiny_wavernn_raw.msgpack"),
            (quick_start.TTS_ZIP, "tiny_tacotron.msgpack")):
        with zipfile.ZipFile(tmp_path / zip_name, "w") as zf:
            zf.write(GOLDEN / weights, "latest_weights.msgpack")
    d = META["dims"]
    tts = dict(tts_embed_dims=d["embed_dims"],
               tts_encoder_dims=d["encoder_dims"],
               tts_decoder_dims=d["decoder_dims"],
               tts_postnet_dims=d["postnet_dims"],
               tts_encoder_K=d["encoder_K"], tts_lstm_dims=d["lstm_dims"],
               tts_postnet_K=d["postnet_K"],
               tts_num_highways=d["num_highways"],
               tts_schedule=[(2, 1e-4, 10_000, 8)])
    (tmp_path / "hp_tiny.py").write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        + "".join(f"{k} = {v!r}\n" for k, v in {**TINY_VOC, **tts}.items()))
    (tmp_path / "sentences.txt").write_text("abcde\nab\n")
    monkeypatch.chdir(tmp_path)
    hp.reset()
    yield tmp_path
    hp.reset()


class Recorder:
    """Stands in for a vocoder: records each call and returns silence of
    the length the vocoder would give."""

    def __init__(self, calls):
        self.calls = calls

    def __call__(self, m, batched, target, overlap, mu_law):
        self.calls.append((np.asarray(m), batched, target, overlap,
                           mu_law))
        return np.zeros((np.asarray(m).shape[-1] - 1) * 275, np.float32)


def run_jax(argv, monkeypatch):
    """The JAX quick_start's main (loaded under its own name) with
    ``argv``, its vocoder recorded."""
    from wavernn_tpu.config import hp as jax_hp

    import gen_tacotron
    import gen_wavernn
    from flax import serialization

    class Weights:
        def __init__(self, path):
            blob = serialization.msgpack_restore(Path(path).read_bytes())
            self.params, self.batch_stats = blob["params"], blob["batch_stats"]
            self.step = int(np.asarray(blob["step"]))

        def get_step(self):
            return self.step

    spec = importlib.util.spec_from_file_location(
        "jax_quick_start", REPO / "quick_start.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []
    monkeypatch.setattr(mod, "make_generator",
                        lambda cfg, state: Recorder(calls))
    monkeypatch.setattr(mod, "load_weights", lambda state, path: Weights(path))
    monkeypatch.setattr(gen_wavernn, "build_state", lambda cfg: None)
    monkeypatch.setattr(gen_tacotron, "build_tts_state", lambda cfg, r0: None)
    monkeypatch.setattr(sys, "argv", ["quick_start.py"] + argv)
    jax_hp.reset()
    try:
        mod.main()
    finally:
        jax_hp.reset()
    return calls


def run_port(argv, monkeypatch):
    calls = []
    with monkeypatch.context() as m:
        m.setattr(quick_start, "make_generator",
                  lambda cfg, variables, dev, **kw: Recorder(calls))
        hp.reset()
        try:
            written = quick_start.main(argv)
        finally:
            hp.reset()
    return written, calls


def table_of(out: str) -> str:
    lines = out.splitlines()
    start = lines.index(next(l for l in lines if l.startswith("+")))
    return "\n".join(lines[start:start + 5])


@pytest.mark.parametrize("argv", [["-i", "abcdeabcde"], ["-u"]],
                         ids=["input_batched", "sentences_unbatched"])
def test_table_names_and_mels_are_jax(workdir, monkeypatch, capsys, argv):
    argv = argv + ["--hp_file", "hp_tiny.py"]
    want = run_jax(argv, monkeypatch)
    jax_out = capsys.readouterr().out
    jax_wavs = sorted(p.name for p in (workdir / "quick_start").glob("*.wav"))
    for p in (workdir / "quick_start").glob("*.wav"):
        p.unlink()
    written, got = run_port(argv + ["--device", "cpu"], monkeypatch)
    port_out = capsys.readouterr().out
    assert table_of(port_out) == table_of(jax_out)
    assert sorted(p.name for p in written) == jax_wavs == sorted(
        p.name for p in (workdir / "quick_start").glob("*.wav"))
    assert len(got) == len(want) == (1 if "-i" in argv else 2)
    for (gm, *g_args), (wm, *w_args) in zip(got, want):
        assert g_args == w_args
        assert gm.shape == wm.shape
        np.testing.assert_allclose(gm, wm, atol=1e-3)
