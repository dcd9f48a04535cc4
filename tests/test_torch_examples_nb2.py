"""The port's NB2 example (``wavernn_tpu_torch/examples/
nb2_fit_single_sample.py``) against the JAX example (``examples/
nb2_fit_single_sample.py``), run in process.

The JAX ``main`` runs with its module's ``make_train_step`` and
``Generator`` stubbed out (they record the batches, and the mel and fold
geometry of the generation), so nothing of its training or decode
JIT-compiles; its model's ``init`` is jitted.  Both run on a half-second
tone and a tiny hp file (``hparams.py`` with 32-wide layers and folds of
200 + 2 x 28 samples).  Targets: the window sampler's batches byte-equal
to JAX's, the generated mel too, and the port's written ``.resynth.wav``
of the length JAX's generator gives that mel."""

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import wavio
from wavernn_tpu_torch.examples import nb2_fit_single_sample as nb2
from tests.jax_examples import (  # noqa: F401
    REPO, JittedInit, argv, clean_hp, jax_example,
)
from tests.torch_cpu import one_torch_thread  # noqa: F401

STEPS, BATCH = 3, 2
TINY = ("voc_rnn_dims = 32\nvoc_fc_dims = 32\nvoc_compute_dims = 16\n"
        "voc_res_out_dims = 16\nvoc_res_blocks = 1\nvoc_target = 200\n"
        "voc_overlap = 28\n")


def tiny_hp_file(tmp_path):
    path = tmp_path / "hp_tiny.py"
    path.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        + TINY)
    return path


def tone(tmp_path):
    t = np.arange(11025) / 22050
    path = tmp_path / "tone.wav"
    wavio.save_wav((0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
                   path, 22050)
    return path


@pytest.fixture
def jax_run(tmp_path, monkeypatch, clean_hp):  # noqa: F811
    """The JAX example's recorded batches and generation call."""
    ex = jax_example("nb2_fit_single_sample")
    rec = {"batches": []}
    jax_model = ex.WaveRNN

    def make_train_step(*a, **k):
        def step(state, x, t, m):
            rec["batches"].append((x, t, m))
            return state, 0.0, None
        return step

    class Generator:
        def __init__(self, cfg, variables):
            rec["hop"] = cfg.hop_length

        def __call__(self, mel, **kw):
            rec["mel"], rec["gen_kw"] = mel, kw
            return np.zeros((mel.shape[1] - 1) * rec["hop"], np.float32)

    monkeypatch.setattr(ex, "WaveRNN", lambda cfg: JittedInit(jax_model(cfg)))
    monkeypatch.setattr(ex, "make_train_step", make_train_step)
    monkeypatch.setattr(ex, "Generator", Generator)
    wav, hp_file = tone(tmp_path), tiny_hp_file(tmp_path)
    argv(monkeypatch, "nb2_fit_single_sample.py", "--wav", wav, "--steps",
         STEPS, "--batch_size", BATCH, "--hp_file", hp_file)
    ex.main()
    return rec, wav, hp_file


def test_batches_and_resynth_match_jax_example(jax_run):
    rec, wav, hp_file = jax_run
    hp.configure(hp_file, voc_mode="RAW")
    mel, labels = nb2.utterance(wav)
    rng = np.random.default_rng(0)
    assert len(rec["batches"]) == STEPS
    for want in rec["batches"]:
        got = nb2.window_batch(rng, mel, labels, BATCH)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
    jax_mel = rec["mel"]
    assert mel[:, :nb2.GEN_FRAMES].tobytes() == jax_mel.tobytes()
    assert rec["gen_kw"] == dict(batched=True, target=200, overlap=28,
                                 mu_law=True)
    hp.reset()

    res = nb2.main(["--wav", str(wav), "--steps", str(STEPS),
                    "--batch_size", str(BATCH), "--hp_file", str(hp_file),
                    "--device", "cpu"])
    assert res["path"] == wav.with_suffix(".resynth.wav")
    x, sr = wavio.read_wav_raw(res["path"])
    assert sr == 22050 and x.shape == ((jax_mel.shape[1] - 1) * 275,)
    assert np.isfinite(res["wav"]).all() and res["losses"].shape == (STEPS,)
    assert np.isfinite(res["losses"]).all()


def test_main_fails_without_cuda(tmp_path, monkeypatch, clean_hp):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nb2.main(["--wav", str(tone(tmp_path)), "--steps", "1"])
    assert not hp.is_configured()
