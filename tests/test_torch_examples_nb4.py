"""The port's NB4 example (``wavernn_tpu_torch/examples/
nb4_alternative_model.py``) against the JAX example (``examples/
nb4_alternative_model.py``).

Part A against JAX: the JAX ``main`` runs until its part B begins (its
``WaveRNNConfig.from_hp`` is stubbed to stop it, and its preprocess pool
runs in one process), then its 8 WAVs must be byte-equal to
``alt_corpus``'s and its dataset (ids, lengths and 16-bit labels) equal to
the port's.  Part B: ``main`` on the CPU at a cut depth (2 steps of the
64-wide MOL model) generates the held-out 2 s mel at folds of 2,750 + 2 x
550, finite and longer than a second, and says that it skips the
loss-drop check, which it holds only at the default 150 steps."""

import functools
import pickle

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.examples import nb4_alternative_model as nb4
from tests.jax_examples import argv, clean_hp, jax_example  # noqa: F401
from tests.torch_cpu import one_torch_thread  # noqa: F401


class PartB(Exception):
    pass


def test_part_a_matches_jax_example(tmp_path, monkeypatch, capsys,
                                    clean_hp):  # noqa: F811
    import wavernn_tpu.data.preprocess as jax_pre
    from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig

    def stop(hp):
        raise PartB

    monkeypatch.setattr(jax_pre, "preprocess_dataset", functools.partial(
        jax_pre.preprocess_dataset, n_workers=1))
    monkeypatch.setattr(JaxConfig, "from_hp", staticmethod(stop))
    ex = jax_example("nb4_alternative_model")
    argv(monkeypatch, "nb4_alternative_model.py", "--workspace",
         tmp_path / "jax")
    with pytest.raises(PartB):
        ex.main()
    assert "part A OK: 8 utterances" in capsys.readouterr().out

    nb4.alt_corpus(tmp_path / "port", 22050)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == [f"alt_{i:02d}.wav" for i in range(8)]
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / "wavs" / n).read_bytes())

    from wavernn_tpu.config import hp as jax_hp

    jax_hp.reset()
    res = nb4_part_b(tmp_path / "ws")
    want = pickle.loads((tmp_path / "jax" / "data" / "dataset.pkl")
                        .read_bytes())
    assert sorted(res["dataset"]) == sorted(want) and len(want) == 8
    for uid, _ in want:
        got = np.load(tmp_path / "ws" / "data" / "quant" / f"{uid}.npy")
        ref = np.load(tmp_path / "jax" / "data" / "quant" / f"{uid}.npy")
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        assert got.max() >= 2 ** 9
    out = capsys.readouterr().out
    assert "loss-drop check skipped: 2 steps" in out
    assert "part B OK" in out and res["loss_gate"] is False
    assert np.isfinite(res["wav"]).all() and len(res["wav"]) > 22050
    assert res["path"].exists()


def nb4_part_b(ws):
    return nb4.main(["--steps", "2", "--batch_size", "2", "--workspace",
                     str(ws), "--num_workers", "1", "--device", "cpu"])


def test_main_fails_without_cuda(tmp_path, monkeypatch, clean_hp):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nb4.main(["--steps", "1", "--workspace", str(tmp_path)])
    assert not hp.is_configured()
