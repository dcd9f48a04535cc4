"""The port's NB3 example (``wavernn_tpu_torch/examples/
nb3_fit_long_sample.py``) against the JAX example (``examples/
nb3_fit_long_sample.py``).

Targets: ``synth_corpus`` writes WAVs byte-equal to the JAX function's;
``main`` on the CPU at a cut depth (a 3 s corpus, 2 steps, 2-hop windows,
one preprocess process) writes the audition WAVs and the latest weights
and says that it skips the loss-drop check, which it holds only at the
default 300 steps.  The CPU run reads ``hparams.py`` with folds of 200 + 2
x 28 samples (``default_hparams_path`` patched): at its 11,000 + 2 x 550
the audition's plain decode takes 12,100 serial steps."""

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.examples import nb3_fit_long_sample as nb3
from tests.jax_examples import REPO, clean_hp, jax_example  # noqa: F401
from tests.torch_cpu import one_torch_thread  # noqa: F401


def test_synth_corpus_byte_equal_to_jax(tmp_path):
    ex = jax_example("nb3_fit_long_sample")
    ex.synth_corpus(tmp_path / "jax", 22050, 0.9, 3)
    nb3.synth_corpus(tmp_path / "port", 22050, 0.9, 3)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["long_000.wav", "long_001.wav", "long_002.wav"]
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes())


def test_main_runs_on_cpu(tmp_path, monkeypatch, capsys, clean_hp):  # noqa: F811
    hp_file = tmp_path / "hp_folds.py"
    hp_file.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        "voc_target = 200\nvoc_overlap = 28\n")
    monkeypatch.setattr(nb3, "default_hparams_path", lambda: hp_file)
    res = nb3.main(["--minutes", "0.05", "--steps", "2", "--batch_size", "2",
                    "--seq_hops", "2", "--workspace", str(tmp_path / "ws"),
                    "--num_workers", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loss-drop check skipped: 2 steps" in out and "OK: " in out
    assert res["loss_gate"] is False
    assert np.isfinite([res["loss0"], res["loss1"]]).all()
    assert res["auditions"] and res["paths"].voc_latest_weights.exists()
    assert len(list((tmp_path / "ws" / "data" / "mel").glob("*.npy"))) == 12


def test_loss_gate_holds_at_default_depth():
    assert nb3.loss_gate(5.0, 4.0, 300, 300, 0.5, "loss") is True
    with pytest.raises(AssertionError, match="did not reduce the loss"):
        nb3.loss_gate(5.0, 4.6, 300, 300, 0.5, "loss")
    assert nb3.loss_gate(5.0, 4.6, 20, 300, 0.5, "loss") is False


def test_main_fails_without_cuda(tmp_path, monkeypatch, clean_hp):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nb3.main(["--steps", "1", "--workspace", str(tmp_path)])
    assert not hp.is_configured() and not list(tmp_path.iterdir())
