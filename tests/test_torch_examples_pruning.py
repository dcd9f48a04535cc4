"""The port's pruning example (``wavernn_tpu_torch/examples/
pruning_example.py``) against the JAX example (``examples/
pruning_example.py``), run in process.

The JAX example's initial weights are carried across
(``models/wavernn.py::from_jax_variables``) and the same seeded batch goes
through STEPS steps of each: the ramp's first two prunes (steps 75 and 100),
cut from the example's 300 so that the file stays under 20 s on the CPU
(300 steps of both take ~40 s; ``chip_smoke.py`` runs the port's 300).
The JAX model's ``init`` is jitted (the same weights, bit for bit, in a
third of the time).  Targets: the measured sparsity at every 25th step
equal to JAX's exactly (the kept count follows from the schedule), and the
first 5 losses within 1e-4."""

import jax
import numpy as np
import pytest
import torch

from wavernn_tpu_torch.examples import pruning_example
from wavernn_tpu_torch.models.wavernn import from_jax_variables
from tests.jax_examples import JittedInit, argv, jax_example
from tests.torch_cpu import one_torch_thread  # noqa: F401


STEPS = 100


def test_sparsity_trajectory_matches_jax_example(monkeypatch):
    ex = jax_example("pruning_example")
    jax_model = ex.WaveRNN
    rec = {"losses": [], "batches": [], "sparsity": []}
    new_state = ex.new_train_state

    def new_train_state(params, batch_stats, opt):
        rec["variables"] = jax.device_get({"params": params,
                                           "batch_stats": batch_stats})
        return new_state(params, batch_stats, opt)

    make_step = ex.make_train_step

    def make_train_step(*a, **k):
        step = make_step(*a, **k)

        def recorded(state, x, y, mels):
            out = step(state, x, y, mels)
            rec["losses"].append(float(out[1]))
            rec["batches"].append((x, y, mels))
            return out
        return recorded

    measured = ex.measured_sparsity

    def sparsity(masks):
        rec["sparsity"].append(measured(masks))
        return rec["sparsity"][-1]

    monkeypatch.setattr(ex, "WaveRNN", lambda cfg: JittedInit(jax_model(cfg)))
    monkeypatch.setattr(ex, "new_train_state", new_train_state)
    monkeypatch.setattr(ex, "make_train_step", make_train_step)
    monkeypatch.setattr(ex, "measured_sparsity", sparsity)
    argv(monkeypatch, "pruning_example.py", "--steps", STEPS)
    ex.main()

    cfg = pruning_example.tiny_config()
    batch = pruning_example.noise_batch(cfg)
    for got, want in zip(batch, rec["batches"][0]):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    model = from_jax_variables(rec["variables"], cfg, "cpu")
    losses, trajectory = pruning_example.train_pruned(
        model, [torch.from_numpy(a) for a in batch], STEPS)
    assert [s for _, s in trajectory] == rec["sparsity"]
    assert [s for s, _ in trajectory] == list(range(25, STEPS + 1, 25))
    assert trajectory[1][1] == 0.0 and trajectory[-1][1] > 0.45
    np.testing.assert_allclose([float(l) for l in losses[:5]],
                               rec["losses"][:5], rtol=0, atol=1e-4)


def test_main_runs_on_cpu(capsys):
    res = pruning_example.main(["--steps", "25", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 25 loss=" in out and out.rstrip().endswith("done")
    assert res["losses"].shape == (25,) and np.isfinite(res["losses"]).all()
    assert res["sparsity"] == [(25, 0.0)]


def test_main_fails_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pruning_example.main(["--steps", "1"])
