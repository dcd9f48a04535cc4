"""The port's magnitude pruning against the JAX package's ``Pruner``.

The same weights (JAX's initialization, carried across by
``from_jax_variables``) give the same masks element for element: gate
blocks of the GRU matrices, whole Dense kernels whose smaller side is at
least 64, before the ramp starts, mid-ramp and after it.  The schedule is
computed in float32 in both packages and must be equal bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_training import make_batch
from tests.test_torch_training import port_cfg
from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu import pruning as jp
from wavernn_tpu.models.wavernn import WaveRNN as JaxWaveRNN
from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu_torch.models.wavernn import from_jax_variables, to_jax_tree
from wavernn_tpu_torch.pruning import (
    PruneConfig, Pruner, make_pruner_from_hp, measured_sparsity, sparsity_at,
)
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.wavernn import make_train_step

CFG = PruneConfig(target_sparsity=0.9375, start_step=100, ramp_steps=1000,
                  prune_every=50)


def prunable_model(mode):
    """Dense kernels of 64+ on both sides (I, fc1, fc2; fc3 in RAW) beside
    the gated GRU matrices."""
    jcfg = JaxConfig(rnn_dims=64, fc_dims=64, bits=8, pad=2,
                     upsample_factors=(4, 4), feat_dims=80, compute_dims=16,
                     res_out_dims=16, res_blocks=1, hop_length=16,
                     sample_rate=1000, mode=mode)
    x, _, mels = make_batch(jcfg, B=2)
    v = jax.jit(JaxWaveRNN(jcfg).init, static_argnums=3)(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mels), True)
    v = jax.tree_util.tree_map(np.asarray, v)
    return jcfg, v, from_jax_variables(v, port_cfg(jcfg), "cpu")


def jax_masks(params, step):
    pr = jp.Pruner(jp.PruneConfig(**CFG.__dict__))
    return jax.tree_util.tree_map(np.asarray, pr._compute(params, step))


def test_sparsity_at_matches_jax():
    jcfg = jp.PruneConfig(**CFG.__dict__)
    for step in (0, 99, 100, 101, 137, 550, 777, 1099, 1100, 5000):
        want = np.asarray(jp.sparsity_at(step, jcfg))
        got = sparsity_at(step, CFG)
        assert got.dtype == np.float32 and got == want, step


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
@pytest.mark.parametrize("step", [50, 600, 2000],
                         ids=["before", "mid-ramp", "after"])
def test_masks_match_jax(mode, step):
    _, v, model = prunable_model(mode)
    masks = Pruner(CFG).compute(model, step)
    got = to_jax_tree(masks, model.cfg)
    want = jax_masks(v["params"], step)
    lg = jax.tree_util.tree_leaves_with_path(got)
    lw = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, a), (_, b) in zip(lg, lw):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert measured_sparsity(masks) == pytest.approx(
        jp.measured_sparsity(want), abs=1e-12)
    p = v["params"]
    sparse = lambda m: float((m == 0).mean())
    if step > CFG.start_step:
        assert sparse(got["rnn1"]["cell"]["w_hh"]) > 0.1
        assert sparse(got["fc1"]["kernel"]) > 0.1
        assert sparse(got["fc3"]["kernel"]) == (0.0 if mode == "MOL"
                                                else sparse(got["fc1"]["kernel"]))
    else:
        assert measured_sparsity(masks) == 0.0
    assert p["fc3"]["kernel"].shape[1] == (30 if mode == "MOL" else 256)


def test_masks_for_resume_and_pruned_step():
    """A masked step leaves pruned weights exactly zero; recomputing the
    masks from the stored (masked) weights at the step reproduces them."""
    jcfg, _, model = prunable_model("RAW")
    pruner = Pruner(CFG)
    opt = make_optimizer(1e-3, 4.0)
    state = new_train_state(model, opt)
    state.step = 649
    masks = pruner.maybe_update(pruner.init_masks(model), model, 650)
    assert measured_sparsity(masks) > 0.1
    step = make_train_step(opt, "RAW")
    rng = np.random.default_rng(2)
    for _ in range(3):
        step(state, *make_batch(jcfg, B=2, rng=rng), masks)
    params = dict(model.named_parameters())
    for name, m in masks.items():
        assert torch.all(params[name][m == 0] == 0), name
    assert pruner.maybe_update(masks, model, 652) is masks
    resumed = pruner.masks_for_resume(model, state.step)   # step 652
    for name, m in masks.items():
        assert torch.equal(resumed[name], m), name
    assert all(torch.all(m == 1) for m in
               pruner.masks_for_resume(model, 99).values())


def test_make_pruner_from_hp():
    class HP(dict):
        get = dict.get

    assert make_pruner_from_hp(HP()) is None
    pr = make_pruner_from_hp(HP(voc_prune=True, voc_prune_start=0,
                                voc_prune_every=5))
    assert pr.cfg == PruneConfig(start_step=0, prune_every=5)
