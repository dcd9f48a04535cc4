"""The port's decode kernel module (``ops/cuda_decode.py``) and its float32
reference decoder (``ops/decode.py``) against the JAX package.

* ``pack_weights`` against ``pallas_decode.pack_weights`` on the region
  without the TPU's lane padding;
* ``decode_reference`` (the CUDA kernel's plain PyTorch version) against
  the Pallas kernel run in interpret mode, deterministic, 16 fold rows x
  256 steps, with the thresholds ``chip_smoke.py`` holds the CUDA kernel to:
  first 64 steps within 1e-3, at least 99% of all samples within 2e-2
  (bf16 products are exact in both; the port sums them in float64, the
  Pallas kernel in float32);
* the f32 ``decode_scan`` against the committed golden waveform, with no
  JAX in the loop.

The CUDA kernel itself is tested in ``test_torch_cuda.py``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.models.wavernn import WaveRNN as JaxWaveRNN
from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu.ops import pallas_decode
from wavernn_tpu.ops.decode import extract_decode_weights as jax_extract
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig, from_jax_variables
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.ops.decode import (
    Generator, decode_scan, extract_decode_weights,
)
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
GOLDEN = REPO / "tests" / "golden"


def small_kw(mode):
    return dict(rnn_dims=64, fc_dims=64, compute_dims=32, res_out_dims=32,
                res_blocks=2, mode=mode)


def jax_variables(mode, seed=0):
    kw = small_kw(mode)
    v = JaxWaveRNN(JaxConfig(**kw)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 275)),
        jnp.zeros((1, 5, 80)), True)
    return WaveRNNConfig(**kw), jax.tree_util.tree_map(np.asarray, v)


def both_weights(cfg, v):
    """The JAX DecodeWeights and the port's, from the same variables."""
    model = from_jax_variables(v, cfg, "cpu")
    return jax_extract(v["params"]), extract_decode_weights(model)


def conditioning(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    mels_up = rng.uniform(0, 1, (B, T, cfg.feat_dims)).astype(np.float32)
    aux = rng.uniform(0, 1, (B, T, cfg.res_out_dims)).astype(np.float32)
    return mels_up, aux


def bf16_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def unpadded(jax_arr, shape):
    """The JAX packed array cut to the port's shape: drop the leading
    broadcast row of (1, N) vectors and the lane padding."""
    a = np.asarray(jax_arr)
    if a.ndim == 2 and len(shape) == 1:
        a = a[0]
    return a[tuple(slice(0, s) for s in shape)]


# -- weight packing ------------------------------------------------------

# Products of the GRU1 precomposition through I: both packages form them
# in float32, but XLA's and PyTorch's CPU matmuls sum in different orders,
# so a float32 result may differ in its last bit, and a bf16 result by one
# bf16 step where the float32 value lies at a rounding boundary.
PRECOMPOSED = {"u1", "b1", "w_Im1"}


@pytest.mark.parametrize("int8_hh", [True, False], ids=["int8_hh", "bf16"])
@pytest.mark.parametrize("which", ["small_mol", "small_raw", "golden"])
def test_pack_weights_bit_equal(which, int8_hh):
    if which == "golden":
        blob = load_pytree(REPO / "bench_assets" / "wavernn_mol_golden.msgpack")
        v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
        cfg = WaveRNNConfig()
    else:
        cfg, v = jax_variables("MOL" if which == "small_mol" else "RAW")
    wj, wt = both_weights(cfg, v)
    n_out_pad = -(-cfg.n_classes // 128) * 128
    pj = pallas_decode.pack_weights(wj, cfg.feat_dims, cfg.aux_dims,
                                    n_out_pad, int8_hh=int8_hh)
    pt = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                  int8_hh=int8_hh)
    assert set(k for k, t in pt.items() if t is not None) == set(pj)
    for name, t in pt.items():
        if t is None:
            continue
        j = unpadded(pj[name], tuple(t.shape))
        assert j.shape == tuple(t.shape), name
        if t.dtype == torch.bfloat16:
            assert j.dtype == jnp.bfloat16, name
            gb, wb = bf16_bits(t), bf16_bits(j)
            if name in PRECOMPOSED:
                # one bf16 step (2**-7 of the value), or a near-cancelled
                # sum whose float32 error is below 1e-6 of the matrix scale
                g, w = t.float().numpy(), j.astype(np.float32)
                step = np.maximum(2.0 ** -7 * np.abs(w),
                                  1e-6 * np.abs(w).max())
                assert np.all(np.abs(g - w) <= step), name
                assert np.mean(gb != wb) < 1e-3, name
            else:
                np.testing.assert_array_equal(gb, wb, err_msg=name)
        elif t.dtype == torch.int8:
            assert j.dtype == np.int8, name
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
        else:
            assert t.dtype == torch.float32 and j.dtype == np.float32, name
            if name in PRECOMPOSED:
                # a float32 sum of H products, taken in two orders: a few
                # float32 steps of the vector's scale
                scale = np.abs(j).max()
                np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                           atol=4e-6 * scale, err_msg=name)
            else:
                np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    # the precomposed bias still carries the I bias through w_ih1
    assert not np.array_equal(pt["b1"].numpy()[:cfg.rnn_dims],
                              (wt.gru1_b_ih + wt.gru1_b_hh).numpy()[:cfg.rnn_dims])


def test_pack_stream_and_fold_major_cond_match_jax():
    """The port's conditioning stream is the JAX stream without its zero
    lane padding, and the fold gather takes the same rows."""
    rng = np.random.default_rng(5)
    ts, feat, d, T_mel = 20, 80, 8, 30
    mels_up = rng.uniform(0, 1, (1, T_mel * ts, feat)).astype(np.float32)
    aux_mel = rng.uniform(0, 1, (1, T_mel, 4 * d)).astype(np.float32)
    sj = np.asarray(pallas_decode.pack_stream(
        jnp.asarray(mels_up), jnp.asarray(aux_mel), ts))
    st = cuda_decode.pack_stream(torch.from_numpy(mels_up),
                                 torch.from_numpy(aux_mel), ts)
    L = T_mel * ts
    want = np.concatenate([sj[:, :feat + d], sj[:, 128:128 + 3 * d]], -1)
    assert st.shape == (L, feat + 4 * d) and st.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16_bits(st), bf16_bits(want))
    starts = np.arange(5) * 110
    fj = np.asarray(pallas_decode.fold_major_cond(jnp.asarray(sj), starts, 128))
    ft = cuda_decode.fold_major_cond(st, torch.from_numpy(starts), 128)
    assert ft.shape == (5, 128, feat + 4 * d) and ft.is_contiguous()
    want = np.concatenate([fj[..., :feat + d], fj[..., 128:128 + 3 * d]], -1)
    np.testing.assert_array_equal(bf16_bits(ft), bf16_bits(want))


def test_q8_per_column():
    w = torch.tensor([[0.5, -2.0, 0.0], [-1.0, 1.0, 0.0]])
    q, s = cuda_decode.q8(w)
    assert q.dtype == torch.int8 and s.shape == (3,)
    np.testing.assert_array_equal(q.numpy(), [[64, -127, 0], [-127, 64, 0]])
    np.testing.assert_allclose(s.numpy(), [1 / 127, 2 / 127, 1 / 127])


# -- the kernel's plain version against the Pallas kernel ----------------

@pytest.mark.parametrize("int8_hh", [True, False], ids=["int8_hh", "bf16"])
@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_decode_reference_matches_pallas_interpret(mode, int8_hh):
    cfg, v = jax_variables(mode)
    wj, wt = both_weights(cfg, v)
    B, T = 16, 256
    mels_up, aux = conditioning(cfg, B, T)
    want = np.asarray(pallas_decode.decode(
        wj, jnp.asarray(mels_up), jnp.asarray(aux), jax.random.PRNGKey(0),
        mode=mode, n_classes=cfg.n_classes, deterministic=True,
        interpret=True, int8_hh=int8_hh))
    packed = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                      int8_hh=int8_hh)
    cond = torch.cat([torch.from_numpy(mels_up), torch.from_numpy(aux)],
                     -1).to(torch.bfloat16)
    launches = cuda_decode.decode.launches
    got = cuda_decode.decode(packed, cond, T, seed=0, mode=mode,
                             n_classes=cfg.n_classes,
                             deterministic=True).numpy()
    assert cuda_decode.decode.launches == launches  # CPU: no kernel
    assert got.shape == want.shape == (B, T) and got.dtype == np.float32
    d = np.abs(got - want)
    assert d[:, :64].max() <= 1e-3, d[:, :64].max()
    assert np.mean(d <= 2e-2) >= 0.99, np.mean(d <= 2e-2)
    assert np.all(np.abs(got) <= 1.0)


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_decode_reference_int8_ff_matches_pallas_interpret(mode):
    """The variant with int8 feed-forward matrices, both packages given
    the bounds of JAX's ``ff_ranges`` on the first fold row's
    conditioning: the int8 dots are exact in both, so the thresholds are
    the bf16 variant's (an operand that JAX's float32 sums put on the
    other side of a quantization boundary moves by one int8 step, which
    stays inside them)."""
    from wavernn_tpu.ops.decode import ff_ranges as jax_ff_ranges

    cfg, v = jax_variables(mode)
    wj, wt = both_weights(cfg, v)
    B, T = 16, 256
    mels_up, aux = conditioning(cfg, B, T)
    feat, d = cfg.feat_dims, cfg.aux_dims
    lanes = np.zeros((T, 2 * pallas_decode.LANE), np.float32)
    lanes[:, :feat + d] = np.concatenate([mels_up[0], aux[0, :, :d]], -1)
    lanes[:, pallas_decode.LANE:pallas_decode.LANE + 3 * d] = aux[0, :, d:]
    S = np.asarray(jax_ff_ranges(wj, jnp.asarray(lanes, jnp.bfloat16),
                                 jax.random.PRNGKey(17), mode,
                                 cfg.n_classes))
    want = np.asarray(pallas_decode.decode(
        wj, jnp.asarray(mels_up), jnp.asarray(aux), jax.random.PRNGKey(0),
        mode=mode, n_classes=cfg.n_classes, deterministic=True,
        interpret=True, int8_hh=True, int8_ff=True,
        ff_scales=jnp.asarray(S)))
    packed = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                      int8_hh=True, int8_ff=True,
                                      ff_scales=torch.from_numpy(S.copy()))
    cond = torch.cat([torch.from_numpy(mels_up), torch.from_numpy(aux)],
                     -1).to(torch.bfloat16)
    got = cuda_decode.decode(packed, cond, T, seed=0, mode=mode,
                             n_classes=cfg.n_classes,
                             deterministic=True).numpy()
    assert got.shape == want.shape == (B, T)
    d = np.abs(got - want)
    assert d[:, :64].max() <= 1e-3, d[:, :64].max()
    assert np.mean(d <= 2e-2) >= 0.99, np.mean(d <= 2e-2)
    # the variant differs from the bf16 one
    bf = cuda_decode.decode_reference(
        cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims), cond, T,
        0, mode, cfg.n_classes, True).numpy()
    assert not np.array_equal(bf, got)


def test_decode_reference_sampling_is_seeded():
    """Sampling mode draws from the counter-based bits: the same seed gives
    the same trajectory, another seed another one, and MOL samples stay
    in [-1, 1]."""
    cfg, v = jax_variables("MOL")
    _, wt = both_weights(cfg, v)
    packed = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims)
    mels_up, aux = conditioning(cfg, 4, 64)
    cond = torch.cat([torch.from_numpy(mels_up), torch.from_numpy(aux)],
                     -1).to(torch.bfloat16)
    run = lambda seed: cuda_decode.decode_reference(
        packed, cond, 64, seed, "MOL", cfg.n_classes, False)
    a, b, c = run(7), run(7), run(8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert a.abs().max() <= 1.0 and a.std() > 0


def _mix32_np(x):
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        return x ^ (x >> np.uint32(16))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, 2 ** 32 + 5])
def test_random_bits_match_uint32_hash(seed):
    """The int64 emulation of the kernel's 32-bit hash equals the same
    hash in native uint32 arithmetic."""
    rows = np.arange(7)
    h = _mix32_np(np.uint32((seed & 0xFFFFFFFF) ^ 0x9E3779B9))
    h = _mix32_np(h ^ rows.astype(np.uint32))[:, None]
    h = _mix32_np(h ^ np.uint32(123))
    want = _mix32_np(h ^ np.arange(33, dtype=np.uint32)[None])
    got = cuda_decode.random_bits(seed, torch.arange(7), 123, 33)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    u = cuda_decode.uniform_from_bits(got)
    assert u.dtype == torch.float32 and (u > 0).all() and (u < 1).all()
    want_u = ((want >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0) + np.float32(1e-7)
    np.testing.assert_array_equal(u.numpy(), want_u)


def test_decode_checks_inputs():
    cfg, v = jax_variables("MOL")
    _, wt = both_weights(cfg, v)
    packed = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims)
    cond = torch.zeros(2, 8, cfg.feat_dims + cfg.res_out_dims,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        cuda_decode.decode(packed, cond.float(), 8, 0, "MOL", 30, True)
    with pytest.raises(ValueError, match="outside"):
        cuda_decode.decode(packed, cond, 9, 0, "MOL", 30, True)
    with pytest.raises(ValueError, match="width"):
        cuda_decode.decode(packed, cond[..., 1:], 8, 0, "MOL", 30, True)
    with pytest.raises(ValueError, match="mode"):
        cuda_decode.decode(packed, cond, 8, 0, "MU", 30, True)


# -- the float32 reference decoder ---------------------------------------

def test_decode_scan_reproduces_golden_wav():
    """The committed trained tiny RAW checkpoint and mel, decoded by the
    port's f32 scan backend with the JAX package's golden call, give the
    pinned waveform (the same atol as tests/test_golden.py)."""
    blob = load_pytree(GOLDEN / "tiny_wavernn_raw.msgpack")
    assert int(blob["step"]) == 300
    cfg = WaveRNNConfig(
        rnn_dims=32, fc_dims=32, bits=9, pad=2, upsample_factors=(5, 5, 11),
        feat_dims=80, compute_dims=16, res_out_dims=16, res_blocks=2,
        hop_length=275, sample_rate=22050, mode="RAW")
    gen = Generator(
        cfg, {"params": blob["params"], "batch_stats": blob["batch_stats"]},
        device="cpu", backend="scan", frame_bucket=16, fold_bucket=4,
        deterministic=True)
    mel = np.load(GOLDEN / "tiny_wavernn_raw_mel.npy")
    wav = gen(mel, batched=True, target=2750, overlap=550, mu_law=True)
    want = np.load(GOLDEN / "tiny_wavernn_raw_wav.npy").astype(np.float64)
    assert wav.dtype == np.float64 and wav.shape == want.shape
    np.testing.assert_allclose(wav, want, atol=1e-4)
    assert np.std(wav) > 0.01


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_decode_scan_matches_jax_scan_deterministic(mode):
    from wavernn_tpu.ops.decode import decode_scan as jax_decode_scan

    cfg, v = jax_variables(mode)
    wj, wt = both_weights(cfg, v)
    mels_up, aux = conditioning(cfg, 3, 128)
    want = np.asarray(jax_decode_scan(
        wj, jnp.asarray(mels_up), jnp.asarray(aux), jax.random.PRNGKey(0),
        mode=mode, n_classes=cfg.n_classes, deterministic=True))
    got = decode_scan(wt, torch.from_numpy(mels_up), torch.from_numpy(aux),
                      mode, cfg.n_classes, deterministic=True).numpy()
    # f32 on both sides: only sum order differs
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_decode_scan_sampling_uses_generator():
    cfg, v = jax_variables("RAW")
    _, wt = both_weights(cfg, v)
    mels_up, aux = conditioning(cfg, 2, 32)
    m, a = torch.from_numpy(mels_up), torch.from_numpy(aux)
    run = lambda s: decode_scan(wt, m, a, "RAW", cfg.n_classes,
                                generator=torch.Generator().manual_seed(s))
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    with pytest.raises(ValueError, match="Generator"):
        decode_scan(wt, m, a, "RAW", cfg.n_classes)
