"""Data-parallel training of both models on the CPU, without JAX.

* Two gloo ranks (``wavernn_tpu_torch.tools.multihost_smoke``: two worker
  processes under torchrun's variables, each joined through
  ``parallel.distributed.maybe_initialize_distributed``) run one
  data-parallel step of the tiny RAW vocoder (global batch 8, as
  ``tests/test_parallel.py``'s DP case) and of the tiny Tacotron (B 8,
  L 12, T 20, r 2, dropout and zoneout on), each against the
  single-process port step on the whole batch: in float64 the loss, every
  updated parameter and the BatchNorm running statistics within 1e-5; in
  float32 the loss and the statistics within 1e-5 (the vocoder's
  parameters too; the Tacotron's are printed: see the tool's docstring).
  The single-process step is held to JAX by the training slices' tests.
* A world of one, in this process: the environment gate, and both train
  loops with ``shard_batch`` give bit for bit the weights of the loops
  without it, rank 0 writing the checkpoints.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.models.tacotron import (
    TacotronConfig, from_jax_variables, init_variables,
)
from wavernn_tpu_torch.models.wavernn import WaveRNN, WaveRNNConfig
from wavernn_tpu_torch.parallel import distributed
from wavernn_tpu_torch.parallel.mesh import shard_batch_fn, world_mesh
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.tools import multihost_smoke
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.tacotron import tts_train_loop
from wavernn_tpu_torch.training.wavernn import voc_train_loop
from tests.torch_cpu import one_torch_thread  # noqa: F401


def test_two_gloo_ranks_match_one_process():
    summary = multihost_smoke.launch(multihost_smoke.parse_args(
        ["--device", "cpu", "--timeout", "120"]))
    workers = summary["workers"]
    assert [w["rank"] for w in workers] == [0, 1]
    for w in workers:
        assert w["world"] == 2 and w["all_reduce_ones"] == 2.0
        assert w["backend"] == "gloo"
        for model in ("vocoder", "tacotron"):
            f64, f32 = w[f"{model}_float64"], w[f"{model}_float32"]
            assert max(f64["loss_diff"], f64["param_diff"],
                       f64["stats_diff"]) <= 1e-5
            assert max(f32["loss_diff"], f32["stats_diff"]) <= 1e-5
            assert np.isfinite(f32["loss"])
        assert w["vocoder_float32"]["param_diff"] <= 1e-5
    assert workers[0]["tacotron_float32"]["loss"] == \
        workers[1]["tacotron_float32"]["loss"]


@pytest.fixture()
def world_of_one(monkeypatch, tmp_path):
    """A one-rank gloo group in this process, joined through the
    environment gate; ``hp`` configured for the loops."""
    monkeypatch.setenv("WAVERNN_TPU_DISTRIBUTED", "1")
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed.maybe_initialize_distributed(device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(multihost_smoke.free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert distributed.maybe_initialize_distributed(device="cpu") is False
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert distributed.maybe_initialize_distributed(device="cpu") is False
    hp.reset()
    hp.configure_from_dict({"voc_checkpoint_every": 2,
                            "tts_checkpoint_every": 2})
    try:
        yield world_mesh(), Paths(tmp_path / "data", "voc", "tts",
                                  base=tmp_path)
    finally:
        hp.reset()
        dist.destroy_process_group()


def weights(model):
    return [p.detach().clone() for p in model.parameters()] + [
        b.clone() for b in model.buffers()]


def test_world_of_one_vocoder_loop_is_the_loop(world_of_one):
    plan, paths = world_of_one
    assert (plan.n_data, plan.rank, plan.world) == (1, 0, True)
    cfg = WaveRNNConfig(**multihost_smoke.TINY_VOC)
    rng = np.random.default_rng(0)
    batches = [(rng.uniform(-1, 1, (4, 16)).astype(np.float32),
                rng.integers(0, cfg.n_classes, (4, 16)),
                rng.uniform(0, 1, (4, 8, 8)).astype(np.float32))
               for _ in range(3)]
    out = []
    for shard in (None, shard_batch_fn(plan)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = WaveRNN(cfg)
        opt = make_optimizer(1e-3, 4.0)
        state = voc_train_loop(paths, cfg, new_train_state(model, opt), opt,
                               batches, [], 3, shard_batch=shard,
                               gen_at_checkpoint=False)
        assert state.get_step() == 3
        out.append(weights(model))
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert (paths.voc_checkpoints / "wave_step0K_weights.msgpack").exists()


def test_world_of_one_tacotron_loop_is_the_loop(world_of_one):
    plan, paths = world_of_one
    cfg = TacotronConfig(**multihost_smoke.TINY_TTS)
    rng = np.random.default_rng(1)
    batches = [(rng.integers(1, cfg.num_chars, (2, 6)),
                rng.uniform(-4, 4, (2, 8, cfg.n_mels)).astype(np.float32),
                ["a", "b"], [8, 8]) for _ in range(2)]
    v = init_variables(cfg, 0)
    out = []
    for shard in (None, shard_batch_fn(plan)):
        model = from_jax_variables(v, cfg, "cpu")
        opt = make_optimizer(1e-3, 1.0)
        state = tts_train_loop(paths, cfg, new_train_state(model, opt), opt,
                               batches, 2, 1e-3, 2, "a", shard_batch=shard)
        assert state.get_step() == 2
        out.append(weights(model))
    assert all(torch.equal(a, b) for a, b in zip(*out))
