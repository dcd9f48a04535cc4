"""The port's Tacotron model against the JAX model, float32 on the CPU.

The committed trained tiny Tacotron (``tests/golden/tiny_tacotron.msgpack``)
goes through ``from_jax_variables``; ``encode``, ``postnet_forward`` and a
``decode_step`` of both packages take the same inputs.  Tolerances: 1e-5
absolute where outputs are O(1) (encode, decode_step); the postnet's output
reaches |y| ~ 10 through two 3-tap convolutions of 256 channels and a
BiGRU, so it is held to 1e-5 relative as well (float32 sums in another
order).  The recurrent cells are held to 1e-6 on seeded inputs.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.models.tacotron import Tacotron as JaxTacotron
from wavernn_tpu.models.tacotron import TacotronConfig as JaxConfig
from wavernn_tpu.models.tacotron import init_decoder_carry as jax_carry
from wavernn_tpu.ops import rnn as jax_rnn
from wavernn_tpu_torch.models.tacotron import (
    Tacotron, TacotronConfig, _get, _leaves, from_jax_variables,
    init_decoder_carry, init_variables,
)
from wavernn_tpu_torch.ops import rnn
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
META = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())


@pytest.fixture(scope="module")
def golden():
    blob = load_pytree(GOLDEN / "tiny_tacotron.msgpack")
    v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    cfg = TacotronConfig(**META["dims"])
    return cfg, JaxConfig(**META["dims"]), v, from_jax_variables(v, cfg, "cpu")


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_from_jax_variables_round_trips_every_leaf(golden):
    cfg, _, v, model = golden
    sd = model.state_dict()
    seen = set()
    for coll, path, key, _, to_torch in _leaves(model):
        np.testing.assert_array_equal(
            sd[key].numpy(), to_torch(np.asarray(_get(v[coll], path))))
        seen.add((coll, path))
    want = {(c, p) for c in ("params", "batch_stats") for p in _leaf_paths(v[c])}
    assert seen == want


def test_encode_matches_jax(golden):
    cfg, jcfg, v, model = golden
    x = np.random.default_rng(0).integers(1, cfg.num_chars, (2, 24))
    je, jp = JaxTacotron(jcfg).apply(v, jnp.asarray(x, jnp.int32), False,
                                     method=JaxTacotron.encode)
    with torch.no_grad():
        te, tp = model.encode(torch.from_numpy(x))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


def test_postnet_matches_jax(golden):
    cfg, jcfg, v, model = golden
    mel = np.load(GOLDEN / "tiny_tacotron_mel.npy").T[None]   # (1, T, 80)
    want = np.asarray(JaxTacotron(jcfg).apply(
        v, jnp.asarray(mel), False, method=JaxTacotron.postnet_forward))
    with torch.no_grad():
        got = model.postnet_forward(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("r", [1, 2, 7])
def test_decode_step_matches_jax(golden, r):
    cfg, jcfg, v, model = golden
    rng = np.random.default_rng(r)
    x = rng.integers(1, cfg.num_chars, (1, 16))
    enc, encp = JaxTacotron(jcfg).apply(v, jnp.asarray(x, jnp.int32), False,
                                        method=JaxTacotron.encode)
    carry = [rng.uniform(-0.5, 0.5, np.shape(c)).astype(np.float32)
             for c in jax_carry(jcfg, 1, 16)]
    carry[6] = np.abs(carry[6])                         # cumulative >= 0
    carry[7] = np.abs(carry[7]) / np.abs(carry[7]).sum()
    prev = rng.uniform(-4, 4, (1, cfg.n_mels)).astype(np.float32)
    jc, (jm, js) = JaxTacotron(jcfg).apply(
        v, tuple(map(jnp.asarray, carry)), enc, encp, jnp.asarray(prev), r,
        method=JaxTacotron.decode_step)
    with torch.no_grad():
        tc, (tm, ts) = model.decode_step(
            tuple(map(torch.from_numpy, carry)),
            torch.tensor(np.asarray(enc)),
            torch.tensor(np.asarray(encp)), torch.from_numpy(prev), r)
    assert tm.shape == (1, cfg.n_mels, r)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    z = init_decoder_carry(cfg, 3, 16)
    assert [tuple(t.shape) for t in z] == [np.shape(t) for t in
                                           jax_carry(jcfg, 3, 16)]


def test_additive_attention_decode_step_matches_jax():
    dims = dict(META["dims"], attn_mode="additive")
    jcfg = JaxConfig(**dims)
    x = jnp.zeros((1, 8), jnp.int32)
    jv = JaxTacotron(jcfg).init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        x, jnp.zeros((1, 4, 80)), 2, True)
    v = jax.tree_util.tree_map(np.asarray, dict(jv))
    model = from_jax_variables(v, TacotronConfig(**dims), "cpu")
    enc, encp = JaxTacotron(jcfg).apply(v, x, False, method=JaxTacotron.encode)
    prev = np.random.default_rng(1).uniform(-4, 4, (1, 80)).astype(np.float32)
    _, (jm, js) = JaxTacotron(jcfg).apply(
        v, jax_carry(jcfg, 1, 8), enc, encp, jnp.asarray(prev), 2,
        method=JaxTacotron.decode_step)
    with torch.no_grad():
        _, (tm, ts) = model.decode_step(
            init_decoder_carry(model.cfg, 1, 8),
            torch.tensor(np.asarray(enc)),
            torch.tensor(np.asarray(encp)), torch.from_numpy(prev), 2)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_init_variables_has_flax_shapes_and_laws():
    """Full width: the same tree and shapes as flax's init, and leaf by
    leaf the same spread (std within 10%, or both constant)."""
    cfg = TacotronConfig()
    jv = JaxTacotron(JaxConfig()).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16), jnp.int32), jnp.zeros((1, 4, 80)), 2, True)
    tv = init_variables(cfg, 0)
    for coll in ("params", "batch_stats"):
        paths = set(_leaf_paths(jv[coll]))
        assert paths == set(_leaf_paths(tv[coll]))
        for p in paths:
            a, b = np.asarray(_get(jv[coll], p)), _get(tv[coll], p)
            assert a.shape == b.shape and b.dtype == np.float32, p
            sa, sb = float(a.std()), float(b.std())
            assert abs(sa - sb) <= 0.1 * sa + 1e-7, (p, sa, sb)
            if sa == 0:
                assert np.all(a == b), p
    model = from_jax_variables(tv, cfg, "cpu")
    assert isinstance(model, Tacotron)
    again = init_variables(cfg, 0)
    np.testing.assert_array_equal(
        again["params"]["decoder"]["mel_proj"]["kernel"],
        tv["params"]["decoder"]["mel_proj"]["kernel"])


def test_cells_and_bigru_match_jax():
    rng = np.random.default_rng(5)
    B, T, I, H = 2, 7, 6, 5
    f = lambda *s: rng.normal(0, 0.5, s).astype(np.float32)
    x, h, c = f(B, I), f(B, H), f(B, H)
    w = dict(w_ih=f(I, 4 * H), w_hh=f(H, 4 * H), b_ih=f(4 * H), b_hh=f(4 * H))
    jh, jc = jax_rnn.lstm_cell_step(x, h, c, **w)
    th, tc = rnn.lstm_cell_step(*map(torch.from_numpy, (x, h, c)),
                                **{k: torch.from_numpy(a) for k, a in w.items()})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)

    xs = f(B, T, I)
    jb = jax_rnn.BiGRU(H)
    jv = jb.init(jax.random.PRNGKey(0), jnp.asarray(xs))
    want = np.asarray(jb.apply(jv, jnp.asarray(xs)))
    tb = rnn.BiGRU(I, H)
    with torch.no_grad():
        for d in ("fwd", "bwd"):
            for k, a in jv["params"][d]["cell"].items():
                getattr(getattr(tb, d).cell, k).copy_(torch.tensor(
                    np.asarray(a)))
        got = tb(torch.from_numpy(xs)).numpy()
        ys, hT = tb.fwd(torch.from_numpy(xs))
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(hT.numpy(), ys[:, -1].numpy())


def test_config_from_hp_matches_jax(hp_default):
    """The same hparams file gives the same Tacotron shape in both
    packages (the JAX config's XLA scan knobs aside)."""
    import dataclasses

    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.text.symbols import symbols

    hp.reset()
    try:
        hp.configure(Path(__file__).parent.parent / "hparams.py")
        got = dataclasses.asdict(TacotronConfig.from_hp(hp, len(symbols)))
    finally:
        hp.reset()
    want = dataclasses.asdict(JaxConfig.from_hp(hp_default, len(symbols)))
    assert got == {k: want[k] for k in got}
    assert set(want) - set(got) == {"decoder_remat", "decoder_unroll"}
