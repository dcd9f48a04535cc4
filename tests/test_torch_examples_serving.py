"""The port's serving demo (``wavernn_tpu_torch/examples/serving_demo.py``)
on the CPU: ``main``'s own equalities hold (stream == manual handles bit
for bit, each served session within 1e-6 of its solo stream, a RIFF body,
``served_sessions == 1``), at a cut size set through the module's
constants: folds of 200 + 2 x 28 samples (the plain decode runs 256
serial steps a fold, not 3,850), mels of 10 frames, 2 s slots (a 30 s
slot buffer is ~0.5 GB on the CPU)."""

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.examples import serving_demo
from tests.torch_cpu import one_torch_thread  # noqa: F401

CUT = dict(TARGET=200, OVERLAP=28, TTS_STEPS=10, SLOT_SECONDS=2.0)


@pytest.fixture
def cut(monkeypatch):
    for k, v in CUT.items():
        monkeypatch.setattr(serving_demo, k, v)


def test_main_runs_on_cpu(cut, capsys):
    res = serving_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "OK: stream == manual handles" in out and "http:" in out
    assert [m.shape for m in res["mels"]] == [(80, 10)] * 3
    for w in res["batched"] + res["streamed"]:
        assert w.shape == (9 * 275,) and np.isfinite(w).all()
    for a, b in zip(res["streamed"], res["manual"]):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(res["served"], res["solo"]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert 0 < res["launches"] < 3 * 6      # fewer than the solo streams'
    assert res["wav_bytes"][:4] == b"RIFF"
    assert res["health"]["served_sessions"] == 1


def test_tiny_models_are_seeded():
    a, b = serving_demo.tiny_models(), serving_demo.tiny_models()
    assert a[0] == b[0] and a[2] == b[2]
    assert np.array_equal(a[3]["params"]["rnn1"]["cell"]["w_ih"],
                          b[3]["params"]["rnn1"]["cell"]["w_ih"])
    c = serving_demo.tiny_models(seed=1)
    assert not np.array_equal(a[3]["params"]["fc3"]["kernel"],
                              c[3]["params"]["fc3"]["kernel"])


def test_main_fails_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving_demo.main([])
