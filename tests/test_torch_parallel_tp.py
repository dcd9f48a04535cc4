"""The model axis of the port's mesh on the CPU, without JAX
(``wavernn_tpu_torch/parallel/mesh.py`` and ``tensor_parallel.py``).

* Plans with a model axis: the local plan over ``["cpu"] * 4`` laid out
  as (data 2, model 2), its data shards on the first device of each model
  row, a shape that does not match the devices a ``ValueError``; a world
  plan's data and model indices and the rows ``shard_batch_fn`` gives
  each rank; the scan ``Generator`` over the (2, 2) plan byte-equal to the
  meshless one.
* ``make_param_specs`` and ``shard_params`` on one process: what is
  sharded and on which torch dim, what is not, and the plain names.
* The tensor-parallel train step: one ``tools/multihost_smoke --model 2
  --processes 4`` launch, four gloo ranks as data 2 x model 2, the tiny
  vocoder and the tiny Tacotron of ``tests/test_parallel.py`` with their
  parameters sharded over the model axis, each against the one-process
  step on the whole batch: in float64 the loss, every parameter and the
  BatchNorm statistics within 1e-5; in float32 the loss at rel 1e-5 and
  the statistics within 1e-5 (the parameters are printed, for the Adam
  eps reason of the tool's docstring); every shard is exactly its slice
  of the gathered parameter, and the weights and optimizer files have the
  one-process files' leaves and shapes.
"""

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.models.tacotron import (
    TacotronConfig, from_jax_variables, init_variables,
)
from wavernn_tpu_torch.models.wavernn import WaveRNN, WaveRNNConfig, to_jax_variables
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.parallel.mesh import (
    MeshPlan, make_mesh, shard_batch_fn, shard_rows,
)
from wavernn_tpu_torch.parallel.tensor_parallel import (
    make_param_specs, plain_name, shard_params, sharded_parameters,
)
from wavernn_tpu_torch.tools import multihost_smoke
from tests.torch_cpu import one_torch_thread  # noqa: F401

CPU4 = ["cpu"] * 4
VOC = dict(rnn_dims=32, fc_dims=32, bits=8, pad=2, upsample_factors=(2, 2),
           feat_dims=8, compute_dims=8, res_out_dims=8, res_blocks=1,
           hop_length=4, sample_rate=1000, mode="RAW")


def world(rank, n_data=2, n_model=2):
    return MeshPlan(n_data=n_data, devices=(torch.device("cpu"),),
                    world=True, rank=rank, n_model=n_model)


def test_local_plan_lays_devices_out_by_rows():
    devs = ["cpu", "meta", "cpu", "meta"]
    plan = make_mesh({"data": 2, "model": 2}, devices=devs)
    assert (plan.n_data, plan.n_model, plan.world) == (2, 2, False)
    assert plan.data_devices == (torch.device("cpu"), torch.device("cpu"))
    assert "data=2 model=2" in plan.describe()
    # the model axis takes what the data axis leaves, and the other way
    assert make_mesh({"model": 2}, devices=CPU4).n_data == 2
    assert make_mesh({"data": 1, "model": 4}, devices=CPU4).n_model == 4
    for bad in ({"data": 3, "model": 2}, {"model": 3}, {"data": 2}):
        with pytest.raises(ValueError, match="does not match"):
            make_mesh(bad, devices=CPU4)
    # shard k runs on the first device of model row k
    seen = []
    out = shard_rows(plan, lambda x, row0: (seen.append((x.device.type,
                                                         row0)), x + 1)[1],
                     torch.arange(4.0))
    assert seen == [("cpu", 0), ("cpu", 2)]
    assert torch.equal(out, torch.arange(4.0) + 1)


def test_world_plan_indices_and_rows():
    x = np.arange(16).reshape(8, 2)
    for rank in range(4):
        p = world(rank)
        assert (p.data_rank, p.model_rank) == (rank // 2, rank % 2)
        (got,) = shard_batch_fn(p)(x)
        d = rank // 2
        np.testing.assert_array_equal(got.numpy(), x[4 * d:4 * d + 4])
    with pytest.raises(ValueError, match="divisible"):
        shard_batch_fn(world(0))(np.zeros((3, 2)))


def test_scan_generator_over_data_model_plan_is_meshless():
    """tests/test_parallel.py's Generator case (40 frames, target 16 /
    overlap 8, mu-law), deterministic: byte-equal over (data 2, model 2)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        v = to_jax_variables(WaveRNN(WaveRNNConfig(**VOC)))
    mel = np.random.default_rng(3).uniform(0, 1, (8, 40)).astype(np.float32)
    geom = dict(batched=True, target=16, overlap=8, mu_law=True)
    plain = Generator(WaveRNNConfig(**VOC), v, "cpu", backend="scan",
                      deterministic=True)(mel, **geom)
    gen = Generator(WaveRNNConfig(**VOC), v, "cpu", backend="scan",
                    mesh=make_mesh({"data": 2, "model": 2}, devices=CPU4),
                    deterministic=True)
    got = gen(mel, **geom)
    assert gen._pad_folds(3) == 4 and np.std(plain) > 0
    assert np.array_equal(got, plain)


def test_param_specs_and_local_shard_layout():
    model = WaveRNN(WaveRNNConfig(**VOC))
    specs = make_param_specs(model, 2)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    # Linear weights (out, in) and GRU weights (3H, in) shard dim 0, as
    # flax's (in, out) kernels shard dim 1; their biases shard too
    for name in ("I", "fc1", "fc2", "fc3"):
        assert specs[f"{name}.weight"] == 0 and specs[f"{name}.bias"] == 0
    for cell in ("rnn1", "rnn2"):
        for leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            assert specs[f"{cell}.{leaf}"] == 0
    # conv kernels, BatchNorm scale/bias and the upsampling kernels stay
    for name, dim in specs.items():
        if name.startswith("upsample."):
            assert dim is None, name
    # 3 does not divide 32 (the GRUs' 3H = 96 does)
    three = make_param_specs(model, 3)
    assert three["fc1.weight"] is None and three["rnn1.weight_ih"] == 0
    assert three["rnn1.bias_ih"] == 0

    cfg = TacotronConfig(**multihost_smoke.TINY_TTS)
    taco = from_jax_variables(init_variables(cfg, 0), cfg, "cpu")
    specs = make_param_specs(taco, 2)
    assert specs["encoder.embedding.weight"] is None
    assert specs["decoder.mel_proj.kernel"] == 1
    assert specs["decoder.res_rnn1.w_ih"] == 1
    assert specs["decoder.res_rnn1.b_hh"] == 0
    for name, dim in specs.items():
        if ".bnorm." in name or name.endswith("conv.weight"):
            assert dim is None, name

    # a local plan is not a world plan, and one model rank changes nothing
    with pytest.raises(ValueError, match="world plan"):
        shard_params(make_mesh(devices=CPU4), model)
    assert shard_params(world(0, 4, 1), model) is model
    assert not sharded_parameters(model)
    assert plain_name("decoder.rnn_input.parametrizations.kernel.original") \
        == "decoder.rnn_input.kernel"
    assert plain_name("parametrizations.w.original") == "w"


def test_tensor_parallel_step_matches_one_process():
    summary = multihost_smoke.launch(multihost_smoke.parse_args(
        ["--device", "cpu", "--processes", "4", "--model", "2",
         "--timeout", "120"]))
    workers = summary["workers"]
    assert [(w["data_rank"], w["model_rank"]) for w in workers] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for w in workers:
        assert (w["n_data"], w["n_model"], w["backend"]) == (2, 2, "gloo")
        assert w["all_reduce_ones"] == 2.0
        for model in ("vocoder", "tacotron"):
            f64, f32 = w[f"{model}_float64"], w[f"{model}_float32"]
            assert max(f64["loss_diff"], f64["param_diff"],
                       f64["stats_diff"]) <= 1e-5
            assert f32["loss"] == pytest.approx(f32["single_loss"], rel=1e-5)
            assert f32["stats_diff"] <= 1e-5 and np.isfinite(
                f32["param_diff"])
            for rec in (f64, f32):
                assert rec["sharded"] > 0 and rec["shards_exact"]
                assert rec["tree_layout_equal"] and rec["optim_layout_equal"]
                assert rec["optim_round_trip"]
            assert f64["tree_diff"] <= 1e-5
    for model in ("vocoder", "tacotron"):
        for dtype in ("float64", "float32"):
            assert len({w[f"{model}_{dtype}"]["loss"] for w in workers}) == 1
