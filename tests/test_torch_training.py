"""The port's vocoder training step against the JAX package's.

The tiny config of ``tests/test_training.py``; JAX's initialization is
carried across by ``from_jax_variables``, and the same numpy batches go
through both packages.  Tolerances: train-mode logits within 1e-5
absolute, losses within 1e-6 relative, each gradient within 1e-4 relative
L2, the BatchNorm statistics within 1e-6.  Over three steps of the clipped
Adam: losses within 1e-5 relative, grad norms within 1e-5 relative, at
least 99.9% of parameter elements within 1e-6 and all within 6*lr + 1e-6
(an Adam step moves a weight by about lr at most, whichever way a
gradient of rounding size points).

The MOL cases hold the port against JAX's model in float32 with its MOL
loss evaluated in float64 (``jax_mol64``).  The port computes the loss's
in-bin mass without cancellation (``wavernn_tpu_torch/ops/mol.py``); the
JAX loss's float32 gradient is 1.4e-3 (relative L2) from its own float64
value on these logits, so a float32 JAX reference would measure the JAX
loss's rounding, not the port."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_training import make_batch, tiny_cfg
from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu.models.wavernn import WaveRNN as JaxWaveRNN
from wavernn_tpu.ops.mol import discretized_mix_logistic_loss as jax_mol
from wavernn_tpu.training.state import make_optimizer as jax_optimizer
from wavernn_tpu.training.state import new_train_state
from wavernn_tpu.training.wavernn import make_train_step as jax_train_step
from wavernn_tpu_torch.models.wavernn import (
    WaveRNNConfig, from_jax_variables, gru_sequence, gru_sequence_reference,
    num_params, to_jax_tree, to_jax_variables,
)
from wavernn_tpu_torch.ops.mol import discretized_mix_logistic_loss
from wavernn_tpu_torch.training.state import (
    make_optimizer, new_train_state as torch_state, set_learning_rate,
)
from wavernn_tpu_torch.training.wavernn import make_train_step

MODES = ["RAW", "MOL"]


def jax_mol64(logits, y, **kw):
    """JAX's MOL loss on float64 copies of its inputs (call under
    ``jax.enable_x64``); the loss comes back in float32."""
    return jax_mol(logits.astype(jnp.float64), y.astype(jnp.float64),
                   **kw).astype(jnp.float32)


def port_cfg(jcfg) -> WaveRNNConfig:
    return WaveRNNConfig(
        rnn_dims=jcfg.rnn_dims, fc_dims=jcfg.fc_dims, bits=jcfg.bits,
        pad=jcfg.pad, upsample_factors=jcfg.upsample_factors,
        feat_dims=jcfg.feat_dims, compute_dims=jcfg.compute_dims,
        res_out_dims=jcfg.res_out_dims, res_blocks=jcfg.res_blocks,
        hop_length=jcfg.hop_length, sample_rate=jcfg.sample_rate,
        mode=jcfg.mode)


def setup(mode, seed=0):
    """JAX variables (numpy), the JAX model and the port model on them,
    and a batch of 4."""
    jcfg = tiny_cfg(mode)
    x, y, mels = make_batch(jcfg, B=4, rng=np.random.default_rng(seed))
    v = jax.jit(JaxWaveRNN(jcfg).init, static_argnums=3)(
        jax.random.PRNGKey(seed), jnp.asarray(x[:2]), jnp.asarray(mels[:2]),
        True)
    v = jax.tree_util.tree_map(np.asarray, v)
    model = from_jax_variables(v, port_cfg(jcfg), "cpu").train()
    return jcfg, v, model, (x, y, mels)


def jax_loss(jcfg, mode):
    model = JaxWaveRNN(jcfg)

    def loss_fn(params, batch_stats, x, y, mels):
        logits, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, x, mels, True,
            mutable=["batch_stats"])
        if mode == "RAW":
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
        else:
            loss = jax_mol64(logits, y)
        return loss, (mutated["batch_stats"], logits)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def port_loss(model, batch, mode):
    x, y, mels = (torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
    logits = model(x, mels)
    if mode == "RAW":
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())
    else:
        loss = discretized_mix_logistic_loss(logits, y)
    loss.backward()
    return float(loss.detach()), logits.detach().numpy()


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("mode", MODES)
def test_forward_loss_grads_and_stats_match_jax(mode):
    jcfg, v, model, batch = setup(mode)
    with jax.enable_x64(True):
        (loss_j, (stats_j, logits_j)), grads_j = jax_loss(jcfg, mode)(
            v["params"], v["batch_stats"], *map(jnp.asarray, batch))
    loss_t, logits_t = port_loss(model, batch, mode)

    assert np.abs(logits_t - np.asarray(logits_j)).max() <= 1e-5
    assert abs(loss_t - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    grads_t = to_jax_tree({n: p.grad for n, p in model.named_parameters()},
                          model.cfg)
    lj, lt = leaves(grads_j), leaves(grads_t)
    assert [p for p, _ in lj] == [p for p, _ in lt]
    for (path, gj), (_, gt) in zip(lj, lt):
        assert gt.shape == gj.shape, path
        assert rel_l2(gt, gj) <= 1e-4, (path, rel_l2(gt, gj))
    # flax's running variance is the biased one: torch's unbiased update
    # would differ by B*T/(B*T-1) in the batch term
    stats_t = to_jax_variables(model)["batch_stats"]
    for (path, sj), (_, st) in zip(leaves(stats_j), leaves(stats_t)):
        assert np.abs(st - np.asarray(sj)).max() <= 1e-6, path
    # the batch term really moved the statistics
    moved = [np.abs(np.asarray(sj) - s0).max() for (_, sj), (_, s0) in
             zip(leaves(stats_j), leaves(v["batch_stats"]))]
    assert min(moved) > 1e-3


def test_plain_gru_matches_fused():
    """gru_sequence (ATen's fused GRU here, cuDNN's on the card) against
    the step-by-step plain version, forward and backward."""
    _, _, model, _ = setup("MOL")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 50, 32)).astype(np.float32))
    outs, grads = [], []
    for fn in (gru_sequence, gru_sequence_reference):
        model.zero_grad()
        y = fn(model.rnn1, x)
        (y * y).sum().backward()
        outs.append(y.detach())
        grads.append(model.rnn1.weight_hh.grad.clone())
    assert torch.allclose(outs[0], outs[1], atol=1e-6)
    assert rel_l2(grads[0], grads[1]) <= 1e-5


@pytest.mark.parametrize("mode", MODES)
def test_three_adam_steps_match_jax(mode, monkeypatch):
    lr, clip = 1e-3, 0.1          # the clip engages on these batches
    monkeypatch.setattr("wavernn_tpu.training.wavernn."
                        "discretized_mix_logistic_loss", jax_mol64)
    jcfg, v, model, _ = setup(mode)
    opt_j = jax_optimizer(lr, clip)
    state_j = new_train_state(v["params"], v["batch_stats"], opt_j)
    step_j = jax_train_step(JaxWaveRNN(jcfg), opt_j, mode, donate=False)
    opt_t = make_optimizer(lr, clip)
    state_t = torch_state(model, opt_t)
    step_t = make_train_step(opt_t, mode)
    rng = np.random.default_rng(7)
    clipped = 0
    for i in range(3):
        batch = make_batch(jcfg, B=4, rng=rng)
        with jax.enable_x64(True):
            state_j, loss_j, gn_j = step_j(state_j, *map(jnp.asarray, batch))
        state_t, loss_t, gn_t = step_t(state_t, *batch)
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
        assert abs(float(gn_t) - float(gn_j)) <= 1e-5 * float(gn_j)
        clipped += float(gn_j) >= clip
    assert clipped == 3 and state_t.step == 3
    params_t = to_jax_variables(model)["params"]
    for (path, pj), (_, pt) in zip(leaves(state_j.params), leaves(params_t)):
        d = np.abs(pt - np.asarray(pj))
        assert np.mean(d <= 1e-6) >= 0.999, path
        assert d.max() <= 6 * lr + 1e-6, path
    assert state_t.opt_state.count == int(state_j.opt_state[1].count) == 3


def test_mol_loss_edges_match_jax():
    """The MOL loss and its gradient at the edge bins (y = +-1 and beyond
    +-0.999), at log scales on the floor (the underflow branch) and in the
    middle, against JAX's (in float64): finite, within 1e-5 relative."""
    rng = np.random.default_rng(0)
    n = 10
    y_hat = rng.standard_normal((2, 8, 3 * n)).astype(np.float32)
    y_hat[:, :4, 2 * n:] = -40.0            # log scales under the floor
    y_hat[:, 4:6, 2 * n:] = -9.0            # tiny scales: mass underflows
    y_hat[:, 4:6, n:2 * n] = 0.3
    # +-0.9992 lie beyond the +-0.999 switch to the edge terms in float32
    # and float64 alike (float32(0.999) > 0.999 would not)
    y = np.array([-1.0, 1.0, -0.9995, 0.9995, 0.2, -0.31, 0.9992, -0.9985],
                 np.float32)[None].repeat(2, 0)
    yt = torch.from_numpy(y_hat).requires_grad_(True)
    loss_t = discretized_mix_logistic_loss(yt, torch.from_numpy(y))
    loss_t.backward()
    with jax.enable_x64(True):
        loss_j, g_j = jax.jit(jax.value_and_grad(
            lambda a: jax_mol64(a, jnp.asarray(y))))(jnp.asarray(y_hat))
        per_j = jax_mol64(jnp.asarray(y_hat), jnp.asarray(y), reduce=False)
    assert np.isfinite(float(loss_t.detach()))
    assert torch.isfinite(yt.grad).all()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= \
        1e-5 * abs(float(loss_j))
    assert rel_l2(yt.grad.numpy(), g_j) <= 1e-5
    per_t = discretized_mix_logistic_loss(
        torch.from_numpy(y_hat), torch.from_numpy(y), reduce=False)
    assert per_t.shape == per_j.shape
    np.testing.assert_allclose(per_t.numpy(), np.asarray(per_j), rtol=1e-5,
                               atol=1e-5)


def test_set_learning_rate_keeps_moments():
    _, _, model, batch = setup("RAW")
    opt = make_optimizer(1e-3, 4.0)
    state = torch_state(model, opt)
    make_train_step(opt, "RAW")(state, *batch)
    mu = {k: t.clone() for k, t in state.opt_state.mu.items()}
    set_learning_rate(state.opt_state, 5e-4)
    assert state.opt_state.learning_rate == float(np.float32(5e-4))
    assert state.opt_state.count == 1
    for k, t in state.opt_state.mu.items():
        assert torch.equal(t, mu[k])
    assert any(float(t.abs().sum()) > 0 for t in mu.values())


def test_num_params_matches_jax():
    _, v, model, _ = setup("MOL")
    want = sum(np.asarray(a).size for a in
               jax.tree_util.tree_leaves(v["params"])) / 1e6
    assert num_params(model) == want
