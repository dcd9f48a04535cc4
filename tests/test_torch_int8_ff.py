"""int8_ff, the decode kernel's int8 feed-forward variant, against the JAX
package: the packs, the calibration (``ops.decode.ff_ranges``) and the
slice through ``Generator`` with the variant forced.  The width policy
and the Generator's calibrate-once caching are in
``tests/test_torch_int8_ff_generator.py``, the kernel's plain version
against the Pallas kernel in ``tests/test_torch_decode.py``, the CUDA
kernel in ``tests/test_torch_cuda.py``.

Tolerances: the packs bit for bit (both quantize and fuse in float32 in the
same order); the calibrated bounds within the spread of JAX's own bound
over four keys, widened by 15% (the two packages draw different samples,
and a bound is the largest of 4,096 steps' activations); the slice through
``Generator`` as ``tests/test_torch_generator.py`` holds it (95% of int16
samples within 655 LSB), both packages given one set of bounds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu.ops import decode as jax_decode
from wavernn_tpu.ops import pallas_decode
from wavernn_tpu_torch.models.wavernn import (
    WaveRNN, WaveRNNConfig, from_jax_variables, to_jax_variables,
)
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.ops import decode as port_decode
from wavernn_tpu_torch.ops.decode import (
    Generator, extract_decode_weights, ff_ranges,
)
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.test_torch_decode import REPO, unpadded
from tests.torch_cpu import one_torch_thread  # noqa: F401

TARGET, OVERLAP = 200, 28
# short utterances (frame bucket 8: 1,100 to 3,300 conditioning rows) keep
# each calibration's plain decode short
SERVE = dict(deterministic=True, input_dtype="float16", output_dtype="int16",
             frame_bucket=8)
S = np.array([3.7, 5.1, 6.3], np.float32)   # bounds given to both packs


@functools.lru_cache(maxsize=None)
def small(mode="MOL", seed=0):
    """A seeded small port model (rnn 64) as the JAX config's kwargs and
    the JAX-layout weights both packages load (no JAX init compiles)."""
    kw = dict(rnn_dims=64, fc_dims=64, compute_dims=32, res_out_dims=32,
              res_blocks=2, mode=mode)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = WaveRNN(WaveRNNConfig(**kw)).eval()
    return kw, to_jax_variables(model)


def mel(T, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (80, T)).astype(
        np.float32)


def weights_of(kw, v):
    cfg = WaveRNNConfig(**kw)
    model = from_jax_variables(v, cfg, "cpu")
    return (cfg, jax_decode.extract_decode_weights(v["params"]),
            extract_decode_weights(model))


# -- the packs -----------------------------------------------------------

@pytest.mark.parametrize("int8_hh", [True, False], ids=["int8_hh", "bf16"])
@pytest.mark.parametrize("which", ["small_mol", "golden"])
def test_pack_weights_int8_ff_bit_equal(which, int8_hh):
    """Every int8 matrix and fused scale row bit-equal to the Pallas
    pack's (without its lane padding), and ffq = float32(127) / S."""
    if which == "golden":
        blob = load_pytree(REPO / "bench_assets" /
                           "wavernn_mol_golden.msgpack")
        kw = {}
        v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    else:
        kw, v = small("MOL")
    cfg, wj, wt = weights_of(kw, v)
    n_out_pad = -(-cfg.n_classes // 128) * 128
    pj = pallas_decode.pack_weights(wj, cfg.feat_dims, cfg.aux_dims,
                                    n_out_pad, int8_hh=int8_hh,
                                    int8_ff=True, ff_scales=jnp.asarray(S))
    pt = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                  int8_hh=int8_hh, int8_ff=True,
                                  ff_scales=torch.from_numpy(S))
    assert cuda_decode.is_int8_ff(pt)
    assert set(k for k, t in pt.items() if t is not None) == set(pj) | {
        "ffq"}
    for name in ("w_ih2x", "w_fc1x", "w_fc2x"):
        t = pt[name]
        assert t.dtype == torch.int8, name
        np.testing.assert_array_equal(t.numpy(),
                                      unpadded(pj[name], tuple(t.shape)))
        fs = pt[name + "_fs"]
        assert fs.dtype == torch.float32, name
        np.testing.assert_array_equal(fs.numpy(),
                                      unpadded(pj[name + "_fs"],
                                               tuple(fs.shape)))
    np.testing.assert_array_equal(
        pt["ffq"].numpy(), np.asarray(127.0 / jnp.asarray(S, jnp.float32)))
    # the recurrent and conditioning matrices are the bf16 pack's
    pb = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                  int8_hh=int8_hh)
    for name in ("w_hh1", "w_hh2", "w_aux", "w_Im1", "w_fc3"):
        assert torch.equal(pt[name], pb[name]), name


def test_pack_weights_int8_ff_needs_its_bounds():
    kw, v = small("RAW")
    cfg, _, wt = weights_of(kw, v)
    with pytest.raises(ValueError, match="ff_scales"):
        cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                 int8_ff=True)
    with pytest.raises(ValueError, match=r"\(3,\)"):
        cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                 int8_ff=True, ff_scales=torch.ones(2))


# -- the calibration -----------------------------------------------------

@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_ff_ranges_within_jax_key_spread(mode):
    """The port's bounds on one conditioning stream lie within JAX's own
    bounds over four keys, widened by 15%; both are the 1.3 x |max| of
    [xr, xr2, relu(fc1)], at least 1e-3."""
    kw, v = small(mode)
    cfg, wj, wt = weights_of(kw, v)
    rng = np.random.default_rng(4)
    ts, T_mel = 20, 30
    mels_up = rng.uniform(0, 1, (1, T_mel * ts, cfg.feat_dims)).astype(
        np.float32)
    aux_mel = rng.normal(0, 1, (1, T_mel, cfg.res_out_dims)).astype(
        np.float32)
    sj = pallas_decode.pack_stream(jnp.asarray(mels_up),
                                   jnp.asarray(aux_mel), ts)
    st = cuda_decode.pack_stream(torch.from_numpy(mels_up),
                                 torch.from_numpy(aux_mel), ts)
    want = np.stack([np.asarray(jax_decode.ff_ranges(
        wj, sj, jax.random.PRNGKey(k), mode, cfg.n_classes))
        for k in (17, 18, 19, 20)])
    got = ff_ranges(wt, st, mode, cfg.n_classes,
                    torch.Generator().manual_seed(17))
    assert got.dtype == torch.float32 and got.shape == (3,)
    got = got.numpy()
    assert np.all(got >= want.min(0) * 0.85), (got, want)
    assert np.all(got <= want.max(0) * 1.15), (got, want)
    # the same draws give the same bounds
    again = ff_ranges(wt, st, mode, cfg.n_classes,
                      torch.Generator().manual_seed(17))
    np.testing.assert_array_equal(again.numpy(), got)


def test_ff_ranges_floor_and_steps(monkeypatch):
    """At most FF_CAL_STEPS rows are decoded, and a bound is never below
    the 1e-3 floor (a zero network has zero activations)."""
    assert port_decode.FF_CAL_STEPS == 4096
    monkeypatch.setattr(port_decode, "FF_CAL_STEPS", 64)
    kw, v = small("MOL")
    cfg, _, wt = weights_of(kw, v)
    zero = port_decode.DecodeWeights(
        **{k: torch.zeros_like(t) for k, t in vars(wt).items()})
    rows = torch.rand(100, cfg.feat_dims + cfg.res_out_dims).to(
        torch.bfloat16)
    got = ff_ranges(zero, rows, "MOL", cfg.n_classes,
                    torch.Generator().manual_seed(17))
    np.testing.assert_array_equal(got.numpy(), np.full(3, 1e-3, np.float32))
    a = ff_ranges(wt, rows, "MOL", cfg.n_classes,
                  torch.Generator().manual_seed(1))
    b = ff_ranges(wt, rows[:64], "MOL", cfg.n_classes,
                  torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c = ff_ranges(wt, rows[:65], "MOL", cfg.n_classes,
                  torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.numpy(), c.numpy())


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pallas_decode, "decode", functools.partial(
        pallas_decode.decode, interpret=True))


def test_forced_generator_matches_jax_pallas(interpret_pallas):
    """The slice with the variant forced, port against JAX (Pallas in
    interpret mode), both given the JAX Generator's bounds."""
    kw, v = small("MOL")
    m = mel(6)
    jgen = jax_decode.Generator(JaxConfig(**kw), v, backend="pallas",
                                int8_ff=True, **SERVE)
    want = jgen(m, batched=True, target=TARGET, overlap=OVERLAP,
                mu_law=False)
    scales = torch.from_numpy(np.array(jgen._ff_scales))
    gen = Generator(WaveRNNConfig(**kw), v, device="cpu", int8_ff=True,
                    **SERVE)
    gen.ff_scales = scales
    gen.packed_ff = cuda_decode.pack_weights(
        gen.weights, gen.cfg.feat_dims, gen.cfg.aux_dims, int8_ff=True,
        ff_scales=scales)
    got = gen(m, batched=True, target=TARGET, overlap=OVERLAP, mu_law=False)
    assert gen.ff_scales is scales
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    lsb = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert np.mean(lsb <= 655) >= 0.95, np.mean(lsb <= 655)
