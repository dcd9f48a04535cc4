"""The port's teacher-forced Tacotron against the JAX model, float32 on the
CPU, at ``tests/test_tacotron.py``'s tiny sizes.

Weights are the port's seeded flax-layout tree (``init_variables``, with
perturbed BatchNorm statistics), so no JAX init compiles; the same numpy
inputs go through both packages.

* Eval / GTA (``generate_gta=True``): mel, linear and attention within
  1e-5 absolute.  (Train mode against JAX: ``test_torch_tts_training_grads.py``.)
* Zoneout and the train-mode BatchNorm change the graph.
* The dropout masks: keep rates, the ``1 / keep`` scaling, reproducible
  from a generator's seed.
* The fused BiGRU of the train graph against the eager one, forward and
  backward, within float32 rounding (1e-6 absolute, 1e-5 relative L2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tacotron import tiny_cfg
from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu.models.tacotron import Tacotron as JaxTacotron
from wavernn_tpu_torch.models.tacotron import (
    PreNet, TacotronConfig, ZONEOUT_P, draw_decoder_masks,
    from_jax_variables, init_variables, to_jax_variables,
)
from wavernn_tpu_torch.ops.rnn import BiGRU

B, L, T = 2, 11, 12


def port_cfg(jcfg) -> TacotronConfig:
    fields = {f.name for f in dataclasses.fields(TacotronConfig)}
    return TacotronConfig(**{k: v for k, v in
                             dataclasses.asdict(jcfg).items() if k in fields})


def variables(cfg: TacotronConfig, seed=0) -> dict:
    """A seeded flax-layout tree with BatchNorm statistics away from 0/1."""
    v = init_variables(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    stack = [v["batch_stats"]]
    while stack:
        node = stack.pop()
        for k, a in node.items():
            if isinstance(a, dict):
                stack.append(a)
            elif k == "mean":
                node[k] = rng.normal(0, 0.1, a.shape).astype(np.float32)
            else:
                node[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    return v


def batch(cfg, seed=0, steps=T):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, cfg.num_chars, (B, L)).astype(np.int32)
    m = rng.uniform(-4, 4, (B, steps, cfg.n_mels)).astype(np.float32)
    return x, m


def zoneout_masks(cfg, T_dec, seed=0):
    """(prenet keep x2: all ones, zoneout keep-prev x2: numpy draws)."""
    rng = np.random.default_rng(seed + 7)
    D, H = cfg.decoder_dims, cfg.lstm_dims
    return (np.ones((T_dec, B, D), bool), np.ones((T_dec, B, D // 2), bool),
            rng.uniform(size=(T_dec, B, H)) < ZONEOUT_P,
            rng.uniform(size=(T_dec, B, H)) < ZONEOUT_P)


def jax_cfg(**kw):
    """The tiny config; the decoder scan not unrolled (the same math, a
    quicker compile)."""
    return dataclasses.replace(tiny_cfg(), decoder_unroll=1, **kw)


@pytest.mark.parametrize("r", [2, 3])
def test_gta_forward_matches_jax(r):
    jcfg = jax_cfg()
    cfg = port_cfg(jcfg)
    v = variables(cfg)
    x, m = batch(cfg, r)
    want = JaxTacotron(jcfg).apply(v, jnp.asarray(x), jnp.asarray(m), r,
                                   False, generate_gta=True)
    model = from_jax_variables(v, cfg, "cpu").train()   # generate_gta wins
    with torch.no_grad():
        got = model(torch.from_numpy(x).long(), torch.from_numpy(m), r,
                    generate_gta=True)
    assert [tuple(t.shape) for t in got] == [(B, T, cfg.n_mels),
                                             (B, T, cfg.fft_bins),
                                             (B, T // r, L)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # eval mode leaves the running statistics alone
    np.testing.assert_array_equal(
        to_jax_variables(model)["batch_stats"]["postnet"]["bank1"]["bnorm"]
        ["mean"], v["batch_stats"]["postnet"]["bank1"]["bnorm"]["mean"])


def test_zoneout_changes_the_train_graph():
    """With zoneout masks of all zeros the train graph (dropout 0) is the
    eval graph's decoder; with real masks it is not."""
    cfg = port_cfg(dataclasses.replace(tiny_cfg(), dropout=0.0))
    model = from_jax_variables(variables(cfg, 2), cfg, "cpu")
    x, m = (torch.from_numpy(a) for a in batch(cfg, 2))
    x = x.long()
    none = tuple(torch.from_numpy(a) for a in zoneout_masks(cfg, T // 3))
    off = none[:2] + (torch.zeros_like(none[2]), torch.zeros_like(none[3]))
    with torch.no_grad():
        # the postnet differs between modes (batch statistics): compare the
        # decoder's mel head only
        train_off = model(x, m, 3, True, masks=off)[0]
        train_on = model(x, m, 3, True, masks=none)[0]
        enc_train = model.encode(x, True)[0]
        enc_eval = model.encode(x, False)[0]
    assert not torch.allclose(enc_train, enc_eval)       # batch statistics
    assert not torch.allclose(train_off, train_on)


def test_dropout_masks_rates_scaling_and_seed():
    cfg = TacotronConfig(decoder_dims=64, lstm_dims=96, dropout=0.5)
    g = lambda s: torch.Generator().manual_seed(s)
    a = draw_decoder_masks(cfg, 300, 4, "cpu", g(3))
    b = draw_decoder_masks(cfg, 300, 4, "cpu", g(3))
    c = draw_decoder_masks(cfg, 300, 4, "cpu", g(4))
    assert [tuple(t.shape) for t in a] == [(300, 4, 64), (300, 4, 32),
                                           (300, 4, 96), (300, 4, 96)]
    assert all(t.dtype == torch.bool for t in a)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])
    for t, want in zip(a, (0.5, 0.5, ZONEOUT_P, ZONEOUT_P)):
        n = t.numel()
        assert abs(float(t.float().mean()) - want) <= 4 * (want * (1 - want)
                                                         / n) ** 0.5
    # the prenet keeps with probability 1 - dropout and scales by 1 / keep
    net = PreNet(8, 4000, 4000, dropout=0.25)
    with torch.no_grad():
        net.fc1.kernel.fill_(0.01)
        net.fc2.kernel.fill_(0.01)
        x = torch.ones(3, 8)
        clean = net(x)
        out1 = net(x, train=True, generator=g(9))
        out2 = net(x, train=True, generator=g(9))
    assert torch.equal(out1, out2)
    kept = out1 != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert not torch.allclose(out1, clean)
    # the kept values of the last layer are scaled by 1 / 0.75
    fc2_in = net.fc1(x).relu()
    with torch.no_grad():
        m1 = torch.rand(fc2_in.shape, generator=g(9)) < 0.75
        h = torch.where(m1, fc2_in / 0.75, 0.0)
        want = net.fc2(h).relu()
    np.testing.assert_allclose(out1[kept].numpy(), (want / 0.75)[kept].numpy(),
                               rtol=1e-6)
    # no dropout in eval mode, nor at rate 0
    net0 = PreNet(8, 16, 16, dropout=0.0)
    with torch.no_grad():
        assert torch.equal(net0(x, train=True, generator=g(1)), net0(x))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_fused_bigru_matches_eager():
    rng = np.random.default_rng(3)
    gru = BiGRU(12, 16)
    xs = torch.from_numpy(rng.standard_normal((3, 40, 12)).astype(np.float32))
    outs, grads = [], []
    for fused in (True, False):
        gru.zero_grad()
        y = gru(xs, fused=fused)
        (y * y).sum().backward()
        outs.append(y.detach())
        grads.append({n: p.grad.clone() for n, p in gru.named_parameters()})
    assert outs[0].shape == (3, 40, 32)
    assert torch.allclose(outs[0], outs[1], atol=1e-6)
    for n in grads[1]:
        assert rel_l2(grads[0][n], grads[1][n]) <= 1e-5, n
