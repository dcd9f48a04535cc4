"""Sequence-chunked BPTT (``WaveRNNConfig.seq_chunks``,
``chunk_warmup``) in the port, against the JAX package on the CPU.

The tiny config of ``tests/test_training.py`` (32-wide, 128-sample
windows); JAX's initialization is carried across by
``from_jax_variables`` and the same numpy inputs go through both
packages.  ``chunk_sequence`` / ``unchunk_sequence`` are held exact; the
train-mode forward, chunked or falling back to unchunked, within 1e-5 of
JAX's logits; with the GRUs memoryless (w_hh zeroed, the update gate
killed) the chunked forward equals the unchunked one within 1e-5; the
eval forward ignores chunking bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_training import make_batch, tiny_cfg
from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu.models import wavernn as jax_wavernn
from wavernn_tpu_torch.models.wavernn import (
    WaveRNNConfig, chunk_sequence, from_jax_variables, unchunk_sequence,
)


def port_cfg(jcfg) -> WaveRNNConfig:
    return WaveRNNConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(WaveRNNConfig)})


def setup(mode="RAW", seed=0, **options):
    """JAX's config with ``options``, its variables (numpy), the port
    model on them in train mode, and a batch of 4."""
    jcfg = dataclasses.replace(tiny_cfg(mode), **options)
    x, y, mels = make_batch(jcfg, B=4, rng=np.random.default_rng(seed))
    v = jax.jit(jax_wavernn.WaveRNN(jcfg).init, static_argnums=3)(
        jax.random.PRNGKey(seed), jnp.asarray(x[:2]), jnp.asarray(mels[:2]),
        True)
    v = jax.tree_util.tree_map(np.asarray, v)
    model = from_jax_variables(v, port_cfg(jcfg), "cpu").train()
    return jcfg, v, model, (x, y, mels)


def jax_forward(jcfg, v, x, mels, train=True):
    model = jax_wavernn.WaveRNN(jcfg)
    if not train:
        return np.asarray(model.apply(v, jnp.asarray(x), jnp.asarray(mels),
                                      False))
    out, _ = model.apply(v, jnp.asarray(x), jnp.asarray(mels), True,
                         mutable=["batch_stats"])
    return np.asarray(out)


def port_forward(model, x, mels):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(mels)).numpy()


@pytest.mark.parametrize("k,warmup", [(2, 0), (2, 3), (4, 6), (3, 8)])
def test_chunk_unchunk_equal_jax(k, warmup):
    t = np.random.default_rng(0).normal(size=(3, 24, 5)).astype(np.float32)
    want = np.asarray(jax_wavernn.chunk_sequence(jnp.asarray(t), k, warmup))
    got = chunk_sequence(torch.from_numpy(t), k, warmup)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        unchunk_sequence(got, 3, k, warmup).numpy(),
        np.asarray(jax_wavernn.unchunk_sequence(jnp.asarray(want), 3, k,
                                                warmup)))
    np.testing.assert_array_equal(unchunk_sequence(got, 3, k, warmup), t)


# T = 128: k = 4 chunks (32 + 10 a row); k = 5 does not divide T and a
# warmup of 40 exceeds T/4: both fall back to the unchunked forward
@pytest.mark.parametrize("mode,k,warmup,chunked", [
    ("RAW", 4, 10, True), ("MOL", 4, 10, True), ("RAW", 5, 10, False),
    ("RAW", 4, 40, False)])
def test_train_forward_matches_jax(mode, k, warmup, chunked):
    jcfg, v, model, (x, _, mels) = setup(mode, seq_chunks=k,
                                         chunk_warmup=warmup)
    assert model.cfg.chunks(x.shape[1]) == chunked
    got = port_forward(model, x, mels)
    want = jax_forward(jcfg, v, x, mels)
    assert got.shape == want.shape == x.shape + (jcfg.n_classes,)
    assert np.abs(got - want).max() <= 1e-5
    # the same model unchunked: different logits when chunking applies
    plain = from_jax_variables(v, port_cfg(tiny_cfg(mode)), "cpu").train()
    differs = np.abs(port_forward(plain, x, mels) - got).max() > 1e-3
    assert differs == chunked


def test_chunked_forward_equals_unchunked_when_memoryless():
    """With w_hh zeroed and the update gate killed (z ~ 0, so h_t = n_t)
    the GRUs have no memory, and the chunked forward must equal the
    unchunked one within 1e-5 (``tests/test_wavernn.py``'s wiring check),
    in both packages."""
    jcfg, v, _, (x, _, mels) = setup("RAW", seq_chunks=4, chunk_warmup=10)
    H = jcfg.rnn_dims
    params = jax.tree_util.tree_map(np.copy, v["params"])
    for r in ("rnn1", "rnn2"):
        cell = params[r]["cell"]
        cell["w_hh"][:] = 0.0
        cell["b_hh"][H:2 * H] = -60.0
        cell["b_ih"][H:2 * H] = -60.0
    v = {"params": params, "batch_stats": v["batch_stats"]}
    outs = [port_forward(from_jax_variables(v, port_cfg(c), "cpu").train(),
                         x, mels)
            for c in (jcfg, tiny_cfg("RAW"))]
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5
    assert np.abs(outs[0] - jax_forward(jcfg, v, x, mels)).max() <= 1e-5


def test_eval_forward_ignores_chunking():
    jcfg, v, model, (x, _, mels) = setup("RAW", seq_chunks=4,
                                         chunk_warmup=10)
    model.eval()
    plain = from_jax_variables(v, port_cfg(tiny_cfg("RAW")), "cpu")
    np.testing.assert_array_equal(port_forward(model, x, mels),
                                  port_forward(plain, x, mels))
    assert np.abs(port_forward(model, x, mels)
                  - jax_forward(jcfg, v, x, mels, train=False)).max() <= 1e-5
