"""The port's conditioning network against the JAX model.

Same weights (the JAX package's variables, carried across by
``from_jax_variables``) and the same mel, made with numpy from a seed, go
through ``WaveRNN.upsample_only``/``upsample_parts`` of both packages.
Tolerance 1e-4 absolute: both run in float32, and the only differences are
the order of the convolution and einsum sums."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.models.wavernn import WaveRNN as JaxWaveRNN
from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.models.wavernn import (
    WaveRNN, WaveRNNConfig, from_jax_variables, stretch_time,
    to_jax_variables,
)
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
ATOL = 1e-4


def small_kw(**over):
    kw = dict(rnn_dims=64, fc_dims=64, compute_dims=32, res_out_dims=32,
              res_blocks=2, mode="MOL")
    kw.update(over)
    return kw


def jax_variables(kw, seed=0):
    """Random JAX variables with non-trivial batch stats and asymmetric
    upsample kernels, as a numpy pytree."""
    cfg = JaxConfig(**kw)
    x = jnp.zeros((1, (5 - 2 * cfg.pad) * cfg.total_scale))
    v = JaxWaveRNN(cfg).init(jax.random.PRNGKey(seed), x,
                             jnp.zeros((1, 5, cfg.feat_dims)), True)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    up = v["params"]["upsample"]
    for k in [k for k in up if k.startswith("up")]:
        up[k] = rng.uniform(0.0, 0.2, up[k].shape).astype(np.float32)
    return cfg, v


def jax_upsample(cfg, v, mels, parts):
    method = (JaxWaveRNN.upsample_parts if parts
              else JaxWaveRNN.upsample_only)
    out = JaxWaveRNN(cfg).apply(v, jnp.asarray(mels), False, method=method)
    return [np.asarray(o) for o in out]


def torch_upsample(model, mels, parts):
    with torch.no_grad():
        m = torch.from_numpy(mels)
        out = model.upsample_parts(m) if parts else model.upsample_only(m)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("parts", [False, True], ids=["only", "parts"])
@pytest.mark.parametrize("T,kw", [
    (20, small_kw()),                       # polyphase form
    (6, small_kw()),                        # T < 7: cascade fallback
    (16, small_kw(pad=1)),                  # pad < 2: cascade fallback
    (12, small_kw(upsample_factors=(4, 5), hop_length=20)),
], ids=["poly", "short", "pad1", "factors45"])
def test_upsample_matches_jax_small(T, kw, parts):
    cfg_j, v = jax_variables(kw)
    cfg = WaveRNNConfig(**kw)
    model = from_jax_variables(v, cfg, "cpu")
    mels = np.random.default_rng(1).uniform(
        0, 1, (2, T, cfg.feat_dims)).astype(np.float32)
    want = jax_upsample(cfg_j, v, mels, parts)
    got = torch_upsample(model, mels, parts)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    # mels_up spans (T - 2*pad) mel frames at sample rate
    assert got[0].shape[1] == (T - 2 * cfg.pad) * cfg.total_scale


@pytest.mark.parametrize("parts", [False, True], ids=["only", "parts"])
def test_upsample_matches_jax_golden(parts):
    """Full-size golden MOL weights on the first 24 frames of the golden
    eval mel."""
    blob = load_pytree(REPO / "bench_assets" / "wavernn_mol_golden.msgpack")
    v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    set_float32_policy()
    model = from_jax_variables(v, WaveRNNConfig(), "cpu")
    mel = np.load(REPO / "bench_assets" / "golden_eval_mel.npy")[:, :24]
    mels = np.ascontiguousarray(mel.T[None])
    want = jax_upsample(JaxConfig(), v, mels, parts)
    got = torch_upsample(model, mels, parts)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_from_jax_variables_layout():
    """Every parameter of the port is set from the pytree (strict load),
    in PyTorch's layout, and the model is in eval mode."""
    kw = small_kw(mode="RAW")
    _, v = jax_variables(kw)
    model = from_jax_variables(v, WaveRNNConfig(**kw), "cpu")
    assert not model.training
    p = v["params"]
    np.testing.assert_array_equal(model.I.weight.detach().numpy(),
                                  p["I"]["kernel"].T)
    np.testing.assert_array_equal(model.rnn2.weight_ih.detach().numpy(),
                                  p["rnn2"]["cell"]["w_ih"].T)
    conv = p["upsample"]["resnet"]["conv_in"]["kernel"]      # (k, in, out)
    np.testing.assert_array_equal(
        model.upsample.resnet.conv_in.weight.detach().numpy(),
        np.transpose(conv, (2, 1, 0)))
    bn = v["batch_stats"]["upsample"]["resnet"]["block1"]["bn2"]
    np.testing.assert_array_equal(
        model.upsample.resnet.blocks[1].bn2.running_var.numpy(), bn["var"])
    assert model.fc3.weight.shape == (512, 64)


def test_stretch_time():
    x = torch.arange(6, dtype=torch.float32).reshape(1, 3, 2)
    y = stretch_time(x, 3)
    assert y.shape == (1, 9, 2)
    np.testing.assert_array_equal(y[0, :3].numpy(), [[0, 1]] * 3)
    np.testing.assert_array_equal(y[0, -1].numpy(), [4, 5])


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def test_fresh_init_follows_flax_laws():
    """Full width: a fresh port model has the JAX init's leaves, and leaf
    by leaf the same spread (std within 10%, widened by three standard
    errors of the difference of two sample stds, sigma / sqrt(n), for the
    small leaves: fc3's 30 biases alone spread by ~13%), or both constant
    and equal.
    The MelResNet convs take flax ``nn.Conv``'s lecun-normal weights and
    zero bias (torch's default law is kaiming-uniform with a uniform
    bias: ``conv_in`` 0.029 against 0.050, ``conv_out``'s bias 0.052
    against 0)."""
    jv = JaxWaveRNN(JaxConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 275)), jnp.zeros((1, 5, 80)),
        True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tv = to_jax_variables(WaveRNN(WaveRNNConfig()))
    for coll in ("params", "batch_stats"):
        want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jv[coll])))
        got = dict(_leaves(tv[coll]))
        assert set(got) == set(want), coll
        for p, a in want.items():
            b = got[p]
            assert a.shape == b.shape, p
            sa, sb = float(a.std()), float(b.std())
            tol = (0.1 + 3.0 / np.sqrt(a.size)) * sa + 1e-7
            assert abs(sa - sb) <= tol, (p, sa, sb)
            if sa == 0:
                np.testing.assert_array_equal(a, b, err_msg=str(p))
    res = tv["params"]["upsample"]["resnet"]
    assert not np.any(res["conv_out"]["bias"])
    # truncated at two standard deviations of the untruncated normal
    k = res["conv_in"]["kernel"]
    assert np.abs(k).max() <= 2.0 / 0.87962566103423978 / np.sqrt(
        k.shape[0] * k.shape[1]) + 1e-7
