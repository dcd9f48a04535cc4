"""The port's CUDA kernels (the WaveRNN decode with its ablations, the
Tacotron decoder steps and the matmul floor) on the card, and the paths
around them: serving, the train step (cuDNN's GRU) against the CPU, and
the training loop's auditions through the decode kernel.

Every test here needs an NVIDIA GPU with the CUDA toolkit, carries the
``cuda`` marker and skips elsewhere.  The module imports no JAX, so that it
runs on a machine with the card, where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Weights are the port's own seeded initialization at a small width (the
float32 accuracy of the train step's gradients is held at full width).  Each
kernel and its plain version (``cuda_decode.decode_reference``,
``tts_decode.tts_decode_reference``, ``matmul_floor.matmul_floor_reference``)
sum the exact bf16 products of every dot in float64, so they agree to the
bit nearly always; the tolerance is the one ``chip_smoke.py`` states: first
64 steps within 1e-3, at least 99% of values within 2e-2 (deterministic),
first 64 steps within 1e-2 (sampling); for the floor, 1e-5 on the state and
1e-9 of the discarded columns' absolute sum on their sum.
"""

import json
from pathlib import Path


import numpy as np
import pytest
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.models.wavernn import (
    WaveRNN, WaveRNNConfig, to_jax_variables,
)
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.infer.gates import gates_pass, tts_gates
from wavernn_tpu_torch.infer.tacotron import TTSGenerator
from wavernn_tpu_torch.models.tacotron import (
    TacotronConfig, from_jax_variables as taco_from_jax, init_variables,
)
from wavernn_tpu_torch.ops import cuda_tts
from wavernn_tpu_torch.ops import matmul_floor as mf
from wavernn_tpu_torch.ops.decode import (
    Generator, extract_decode_weights, ff_ranges,
)
from wavernn_tpu_torch.ops.tts_decode import (
    STATE_FIELDS, extract_tts_decode_weights, init_tts_decode_state,
    pack_tts_weights, tts_decode_reference,
)
from wavernn_tpu_torch.text import text_to_sequence
from wavernn_tpu_torch.utils.checkpoints import load_pytree

GOLDEN = Path(__file__).parent / "golden"

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    """The first CUDA device; skips where there is none (decided at test
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    set_float32_policy()
    return torch.device("cuda", 0)


def small(mode):
    cfg = WaveRNNConfig(rnn_dims=64, fc_dims=64, compute_dims=32,
                        res_out_dims=32, res_blocks=2, mode=mode)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = WaveRNN(cfg).eval()
    return cfg, model


def packed_on(model, cfg, device, int8_hh):
    packed = cuda_decode.pack_weights(extract_decode_weights(model),
                                      cfg.feat_dims, cfg.aux_dims,
                                      int8_hh=int8_hh)
    return {k: (t.to(device) if t is not None else None)
            for k, t in packed.items()}


def conditioning(cfg, B, T, device, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (B, T, cfg.feat_dims + cfg.res_out_dims))
    return torch.from_numpy(c.astype(np.float32)).to(torch.bfloat16).to(
        device)


@pytest.mark.parametrize("det", [True, False], ids=["argmax", "sampling"])
@pytest.mark.parametrize("int8_hh", [True, False], ids=["int8_hh", "bf16"])
@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_kernel_matches_plain_version(cuda_device, mode, int8_hh, det):
    cfg, model = small(mode)
    packed = packed_on(model, cfg, cuda_device, int8_hh)
    B, T = 5, 300                 # an odd row count: a half-empty CTA
    cond = conditioning(cfg, B, T, cuda_device)
    n = cuda_decode.decode.launches
    got = cuda_decode.decode(packed, cond, T, 3, mode, cfg.n_classes, det)
    torch.cuda.synchronize()
    assert cuda_decode.decode.launches == n + 1
    assert got.is_cuda and got.shape == (B, T) and got.dtype == torch.float32
    want = cuda_decode.decode_reference(packed, cond, T, 3, mode,
                                        cfg.n_classes, det)
    d = (got - want).abs().cpu().numpy()
    if det:
        assert d[:, :64].max() <= 1e-3
        assert np.mean(d <= 2e-2) >= 0.99
    else:
        assert d[:, :64].max() <= 1e-2
    assert torch.isfinite(got).all() and got.abs().max() <= 1.0


def ff_packed_on(model, cfg, device, int8_hh, cond):
    """The int8_ff pack, its bounds calibrated (seed 17) on the first row
    of ``cond``."""
    w = extract_decode_weights(model.to(device))
    scales = ff_ranges(w, cond[0], cfg.mode, cfg.n_classes,
                       torch.Generator().manual_seed(17))
    return cuda_decode.pack_weights(w, cfg.feat_dims, cfg.aux_dims,
                                    int8_hh=int8_hh, int8_ff=True,
                                    ff_scales=scales)


@pytest.mark.parametrize("rows_per_cta", [1, 2])
@pytest.mark.parametrize("det", [True, False], ids=["argmax", "sampling"])
@pytest.mark.parametrize("int8_hh", [True, False], ids=["int8_hh", "bf16"])
@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_int8_ff_kernel_matches_plain_version(cuda_device, mode, int8_hh,
                                              det, rows_per_cta):
    """The int8 feed-forward variant against its plain version on the row
    design (the cluster design's cases are tests/test_torch_cuda_cluster.py):
    int8 dots are exact in both, so the tolerance is the one of every
    variant."""
    cfg, model = small(mode)
    B, T = 5, 300
    cond = conditioning(cfg, B, T, cuda_device)
    packed = ff_packed_on(model, cfg, cuda_device, int8_hh, cond)
    assert packed["w_fc1x"].dtype == torch.int8
    n, n_ff = cuda_decode.decode.launches, cuda_decode.decode.launches_int8_ff
    got = cuda_decode.decode(packed, cond, T, 3, mode, cfg.n_classes, det,
                             rows_per_cta=rows_per_cta, design="row")
    torch.cuda.synchronize()
    assert cuda_decode.decode.launches == n + 1
    assert cuda_decode.decode.launches_int8_ff == n_ff + 1
    want = cuda_decode.decode_reference(packed, cond, T, 3, mode,
                                        cfg.n_classes, det)
    d = (got - want).abs().cpu().numpy()
    if det:
        assert d[:, :64].max() <= 1e-3
        assert np.mean(d <= 2e-2) >= 0.99
    else:
        assert d[:, :64].max() <= 1e-2
    assert torch.isfinite(got).all() and got.abs().max() <= 1.0
    with pytest.raises(ValueError, match="ablations"):
        cuda_decode.decode(packed, cond, T, 3, mode, cfg.n_classes, det,
                           ablate=frozenset({"gates"}))


@pytest.mark.parametrize("det", [True, False], ids=["argmax", "sampling"])
@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_int8_gates_kernel_matches_plain_version(cuda_device, mode, det):
    """The int8_gates variant (each operand quantized per row on the fly)
    against its plain version: the row maxima, the divisions and the int8
    sums are exact in both, so they agree to the bit."""
    cfg, model = small(mode)
    B, T = 5, 300
    cond = conditioning(cfg, B, T, cuda_device)
    packed = cuda_decode.pack_weights(
        extract_decode_weights(model.to(cuda_device)), cfg.feat_dims,
        cfg.aux_dims, int8_gates=True)
    n = (cuda_decode.decode.launches, cuda_decode.decode.launches_int8_ff,
         cuda_decode.decode.launches_int8_gates)
    got = cuda_decode.decode(packed, cond, T, 3, mode, cfg.n_classes, det)
    torch.cuda.synchronize()
    assert (cuda_decode.decode.launches, cuda_decode.decode.launches_int8_ff,
            cuda_decode.decode.launches_int8_gates) == (n[0] + 1, n[1],
                                                        n[2] + 1)
    want = cuda_decode.decode_reference(packed, cond, T, 3, mode,
                                        cfg.n_classes, det)
    print(f"int8_gates {mode} det={det}: max|d| "
          f"{float((got - want).abs().max()):.3g}")
    assert torch.equal(got, want)
    assert torch.isfinite(got).all() and got.abs().max() <= 1.0
    with pytest.raises(ValueError, match="int8_gates"):
        cuda_decode.decode(packed, cond, T, 3, mode, cfg.n_classes, det,
                           rows_per_cta=2)


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_ff_ranges_graph_equals_eager_on_card(cuda_device, mode):
    """The calibration's step replayed from a CUDA graph gives the bounds
    of the same step run eagerly on the card, bit for bit."""
    from wavernn_tpu_torch.ops.decode import _draw, _Uniforms, decode_step

    cfg, model = small(mode)
    w = extract_decode_weights(model.to(cuda_device))
    rows = conditioning(cfg, 1, 700, cuda_device)[0].float()
    got = ff_ranges(w, rows, mode, cfg.n_classes,
                    torch.Generator().manual_seed(17))
    n_u = cfg.n_classes // 3 + 1 if mode == "MOL" else cfg.n_classes
    u = torch.rand(700, n_u, generator=torch.Generator().manual_seed(17))
    u = u.to(cuda_device)
    H, d, feat = cfg.rnn_dims, cfg.aux_dims, cfg.feat_dims
    x = torch.zeros(1, 1, device=cuda_device)
    h1 = h2 = torch.zeros(1, H, device=cuda_device)
    mx = torch.zeros(3, device=cuda_device)
    for t in range(700):
        c = rows[t:t + 1]
        a = [c[:, feat + i * d:feat + (i + 1) * d] for i in range(4)]
        logits, h1, h2, (xr, xr2, f1) = decode_step(w, x, h1, h2,
                                                    c[:, :feat], *a)
        mx = torch.maximum(mx, torch.stack([xr.abs().max(),
                                            xr2.abs().max(), f1.max()]))
        x = _draw(logits, mode, cfg.n_classes, False, _Uniforms(u[t]))[:, None]
    want = torch.clamp(mx * 1.3, min=1e-3)
    assert got.is_cuda and bool((got > 1e-3).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_ff_generator_on_card_matches_cpu(cuda_device):
    """``int8_ff=True``: both Generators calibrate once, on the same draws,
    and every launch on the card takes the int8 pack."""
    cfg, model = small("MOL")
    v = to_jax_variables(model)
    kw = dict(deterministic=True, input_dtype="float16",
              output_dtype="int16", fold_bucket=16, int8_ff=True)
    mel = np.random.default_rng(0).uniform(0, 1, (80, 20)).astype(np.float32)
    cpu_gen = Generator(cfg, v, device="cpu", **kw)
    cpu = cpu_gen(mel, batched=True, target=200, overlap=28, mu_law=False)
    gen = Generator(cfg, v, device=cuda_device, **kw)
    n_ff = cuda_decode.decode.launches_int8_ff
    out = gen(mel, batched=True, target=200, overlap=28, mu_law=False)
    scales = gen.ff_scales
    gen(mel, batched=True, target=200, overlap=28, mu_law=False)
    assert gen.ff_scales is scales                 # calibrated once
    assert cuda_decode.decode.launches_int8_ff == n_ff + 2
    # the same draws; float32 sums in another order may move a sampled
    # trajectory, and with it a bound, by a little
    torch.testing.assert_close(scales.cpu(), cpu_gen.ff_scales, rtol=0.05,
                               atol=0)
    lsb = np.abs(out.astype(np.int32) - cpu.astype(np.int32))
    assert out.shape == cpu.shape and np.mean(lsb <= 655) >= 0.95


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    cfg, model = small("MOL")
    packed = packed_on(model, cfg, cuda_device, True)
    cond = conditioning(cfg, 2, 16, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_decode.decode(packed, cond.transpose(0, 1).contiguous()
                           .transpose(0, 1), 16, 0, "MOL", 30, True)
    cpu_packed = packed_on(model, cfg, "cpu", True)
    with pytest.raises(ValueError, match="packed"):
        cuda_decode.decode(cpu_packed, cond, 16, 0, "MOL", 30, True)
    with pytest.raises(ValueError, match="n_classes"):
        cuda_decode.decode(packed, cond, 16, 0, "MOL", 31, True)


@pytest.mark.parametrize("det", [True, False], ids=["argmax", "sampling"])
@pytest.mark.parametrize("ablate", cuda_decode.KERNEL_ABLATIONS[1:],
                         ids=lambda a: "+".join(sorted(a)))
def test_ablated_kernel_matches_ablated_plain_version(cuda_device, ablate,
                                                      det):
    cfg, model = small("MOL")
    packed = packed_on(model, cfg, cuda_device, True)
    B, T = 5, 128
    cond = conditioning(cfg, B, T, cuda_device)
    n = cuda_decode.decode.launches
    got = cuda_decode.decode(packed, cond, T, 3, "MOL", cfg.n_classes, det,
                             ablate=ablate)
    torch.cuda.synchronize()
    assert cuda_decode.decode.launches == n + 1
    assert got.shape == (B, T) and got.dtype == torch.float32
    if "out_write" in ablate:        # the output is unspecified
        return
    want = cuda_decode.decode_reference(packed, cond, T, 3, "MOL",
                                        cfg.n_classes, det, ablate=ablate)
    d = (got - want).abs().cpu().numpy()
    assert d[:, :64].max() <= (1e-3 if det else 1e-2)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("int8_hh", [True, False], ids=["int8_hh", "bf16"])
def test_kernel_one_row_per_cta_matches_plain_version(cuda_device, int8_hh):
    cfg, model = small("RAW")
    packed = packed_on(model, cfg, cuda_device, int8_hh)
    cond = conditioning(cfg, 3, 200, cuda_device)
    got = cuda_decode.decode(packed, cond, 200, 5, "RAW", cfg.n_classes,
                             False, rows_per_cta=1, design="row")
    want = cuda_decode.decode_reference(packed, cond, 200, 5, "RAW",
                                        cfg.n_classes, False)
    assert float((got - want).abs()[:, :64].max()) <= 1e-2
    with pytest.raises(ValueError, match="ablations"):
        cuda_decode.decode(packed, cond, 200, 5, "RAW", cfg.n_classes, True,
                           ablate=frozenset({"gates"}),
                           rows_per_cta=3 - cuda_decode.ROWS_PER_CTA)


@pytest.mark.parametrize("B", [5, 64])
def test_floor_kernel_matches_plain_version(cuda_device, B):
    w = mf.make_floor_weights(0, device=cuda_device)
    h0 = torch.from_numpy(np.random.default_rng(B).uniform(
        -1, 1, (B, mf.H_FLOOR)).astype(np.float32)).to(cuda_device)
    n = mf.matmul_floor.launches
    h, sink, sink_abs = mf.matmul_floor(w, B, 48, h0)
    torch.cuda.synchronize()
    assert mf.matmul_floor.launches == n + 1
    hr, sr, sar = mf.matmul_floor_reference(w, B, 48, h0)
    assert float((h - hr).abs().max()) <= 1e-5
    assert float(h.abs().max()) > 0.1
    assert bool(((sink - sr).abs() <= 1e-9 * sar).all())
    assert bool(((sink_abs - sar).abs() <= 1e-9 * sar).all())
    zero, _, zabs = mf.matmul_floor(w, B, 4)     # the JAX kernel's start
    assert float(zero.abs().max()) == 0.0 and float(zabs.max()) == 0.0
    with pytest.raises(ValueError, match="h0"):
        mf.matmul_floor(w, B, 4, h0.cpu())


# -- the split-K dots at widths that do not divide evenly -------------------

def seeded_model(cfg):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return WaveRNN(cfg).eval()


@pytest.mark.parametrize("rows_per_cta", [1, 2])
@pytest.mark.parametrize("int8_hh", [True, False], ids=["int8_hh", "bf16"])
@pytest.mark.parametrize("width,mode", [(48, "MOL"), (80, "RAW")])
def test_kernel_uneven_splits_match_plain_version_exactly(
        cuda_device, width, mode, int8_hh, rows_per_cta):
    """H = F = 48 or 80: column groups (3H/16 int8, 3H/8 and F/8 bf16) and
    K-slices that do not divide the CTA's threads evenly; K0 = 80 + 9, odd;
    5 rows, not a multiple of R.  Held to max |d| 0 in both decode modes,
    on the row design (the cluster design's case:
    tests/test_torch_cuda_cluster.py)."""
    cfg = WaveRNNConfig(rnn_dims=width, fc_dims=width, compute_dims=32,
                        res_out_dims=36, res_blocks=2, mode=mode)
    packed = packed_on(seeded_model(cfg), cfg, cuda_device, int8_hh)
    assert packed["w_Im"].shape[0] == 89
    B, T = 5, 200
    cond = conditioning(cfg, B, T, cuda_device)
    for det in (True, False):
        got = cuda_decode.decode(packed, cond, T, 3, mode, cfg.n_classes,
                                 det, rows_per_cta=rows_per_cta, design="row")
        torch.cuda.synchronize()
        want = cuda_decode.decode_reference(packed, cond, T, 3, mode,
                                            cfg.n_classes, det)
        assert got.shape == (B, T) and torch.isfinite(got).all()
        assert float((got - want).abs().max()) == 0.0, f"det={det}"


def test_kernel_rejects_what_the_wide_loads_do_not_take(cuda_device):
    cfg = WaveRNNConfig(rnn_dims=40, fc_dims=40, compute_dims=32,
                        res_out_dims=32, res_blocks=2, mode="MOL")
    packed = packed_on(seeded_model(cfg), cfg, cuda_device, True)
    cond = conditioning(cfg, 2, 16, cuda_device)
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_decode.decode(packed, cond, 16, 0, "MOL", cfg.n_classes, True)
    cfg, model = small("MOL")
    packed = packed_on(model, cfg, cuda_device, True)
    w = packed["w_fc2x"]
    shifted = torch.empty(w.numel() + 1, dtype=w.dtype, device=w.device)
    shifted[1:].copy_(w.flatten())
    bad = dict(packed, w_fc2x=shifted[1:].view(w.shape))
    cond = conditioning(cfg, 2, 16, cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        cuda_decode.decode(bad, cond, 16, 0, "MOL", cfg.n_classes, True)


@pytest.mark.parametrize("B", [5, 64])
def test_floor_kernel_state_matches_plain_version_exactly(cuda_device, B):
    w = mf.make_floor_weights(1, device=cuda_device)
    h0 = torch.from_numpy(np.random.default_rng(B + 1).uniform(
        -1, 1, (B, mf.H_FLOOR)).astype(np.float32)).to(cuda_device)
    h, _, _ = mf.matmul_floor(w, B, 32, h0)
    torch.cuda.synchronize()
    hr, _, _ = mf.matmul_floor_reference(w, B, 32, h0)
    assert float((h - hr).abs().max()) == 0.0
    shifted = torch.empty(w["w3"].numel() + 8, dtype=torch.bfloat16,
                          device=cuda_device)
    bad = dict(w, w3=shifted[1:1 + w["w3"].numel()].view(w["w3"].shape))
    with pytest.raises(ValueError, match="aligned"):
        mf.matmul_floor(bad, B, 4, h0)


def test_generator_on_card_matches_cpu(cuda_device):
    """The slice on the card goes through the kernel, once per request,
    and gives the int16 PCM the same Generator gives on the CPU."""
    cfg, model = small("MOL")
    v = to_jax_variables(model)
    kw = dict(deterministic=True, input_dtype="float16",
              output_dtype="int16", fold_bucket=16)
    mel = np.random.default_rng(0).uniform(0, 1, (80, 20)).astype(np.float32)
    cpu = Generator(cfg, v, device="cpu", **kw)(
        mel, batched=True, target=200, overlap=28, mu_law=False)
    gen = Generator(cfg, v, device=cuda_device, **kw)
    n = cuda_decode.decode.launches
    out = gen(mel, batched=True, target=200, overlap=28, mu_law=False)
    assert cuda_decode.decode.launches == n + 1
    assert out.dtype == np.int16 and out.shape == cpu.shape == (19 * 275,)
    lsb = np.abs(out.astype(np.int32) - cpu.astype(np.int32))
    assert np.mean(lsb <= 655) >= 0.95


@pytest.mark.parametrize("rows_per_cta", [1, 2])
def test_kernel_at_240_rows_matches_plain_version_exactly(cuda_device,
                                                          rows_per_cta):
    """Five co-batched 1920-frame requests make 240 fold rows: on the row
    design, two waves of one-row CTAs on 132 SMs (the cluster design's
    case: tests/test_torch_cuda_cluster.py).  Held to max |d| 0 over 64
    steps in both decode modes."""
    cfg, model = small("MOL")
    packed = packed_on(model, cfg, cuda_device, True)
    B, T = 240, 64
    cond = conditioning(cfg, B, T, cuda_device, seed=240)
    for det in (True, False):
        got = cuda_decode.decode(packed, cond, T, 5, "MOL", cfg.n_classes,
                                 det, rows_per_cta=rows_per_cta, design="row")
        torch.cuda.synchronize()
        want = cuda_decode.decode_reference(packed, cond, T, 5, "MOL",
                                            cfg.n_classes, det)
        assert got.shape == (B, T) and torch.isfinite(got).all()
        assert float((got - want).abs().max()) == 0.0, f"det={det}"


def serving_generator(device, **kw):
    cfg, model = small("MOL")
    kw = {"deterministic": True, "input_dtype": "float16",
          "output_dtype": "int16", "fold_bucket": 16, **kw}
    return Generator(cfg, to_jax_variables(model), device=device, **kw)


def serving_mels(frames, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (80, f)).astype(np.float32) for f in frames]


def test_stream_equals_stream_oneshot_bytes_on_card(cuda_device):
    """A deterministic stream (ramped first group) is byte for byte its
    one-shot oracle, through one launch per fold span."""
    from wavernn_tpu_torch.ops.decode import fold_spans

    gen = serving_generator(cuda_device)
    (mel,) = serving_mels([30])
    kw = dict(target=200, overlap=28, mu_law=False, group=8, first_group=2)
    n = cuda_decode.decode.launches
    chunks = list(gen.stream(mel, **kw))
    needed = -(-29 * 275 // 228)
    assert cuda_decode.decode.launches - n == len(fold_spans(needed, 8, 2))
    oneshot = gen.stream_oneshot(mel, **kw)
    got = np.concatenate(chunks)
    assert got.dtype == oneshot.dtype == np.int16
    assert got.shape == oneshot.shape == (29 * 275,)
    np.testing.assert_array_equal(got, oneshot)


def test_stream_server_equals_solo_streams_on_card(cuda_device):
    from wavernn_tpu_torch.infer.stream_server import StreamServer

    gen = serving_generator(cuda_device)
    mels = serving_mels([30, 12, 21], seed=1)
    kw = dict(target=200, overlap=28, mu_law=False)
    solo = [np.concatenate(list(gen.stream(m, group=4, **kw)))
            for m in mels]
    srv = StreamServer(gen, group=4, width=16, capacity=2, slot_seconds=1.0,
                       **kw)
    for got, want in zip(srv.run(mels), solo):
        np.testing.assert_array_equal(got, want)
    assert srv.launches < sum(-(-len(w) // 228 // 4) for w in solo)


def test_uint8_ingress_bit_exact_on_card(cuda_device):
    (mel,) = serving_mels([25], seed=2)
    q = (np.clip(np.round(mel * 255.0), 0.0, 255.0)
         * np.float32(1.0 / 255.0)).astype(np.float32)
    kw = dict(batched=True, target=200, overlap=28, mu_law=False)
    got = serving_generator(cuda_device, input_dtype="uint8")(mel, **kw)
    want = serving_generator(cuda_device, input_dtype="float32")(q, **kw)
    np.testing.assert_array_equal(got, want)


def test_cobatched_serve_is_one_launch_on_card(cuda_device):
    gen = serving_generator(cuda_device)
    mels = serving_mels([20, 9, 14], seed=3)
    staged = gen.prestage_batch(mels, 200, 28)
    n = cuda_decode.decode.launches
    waves = gen.generate_batch(staged, target=200, overlap=28, mu_law=False)
    assert cuda_decode.decode.launches == n + 1
    for w, m in zip(waves, mels):
        solo = gen(m, batched=True, target=200, overlap=28, mu_law=False)
        assert w.dtype == np.int16 and w.shape == solo.shape
        lsb = np.abs(w.astype(np.int32) - solo.astype(np.int32))
        assert np.mean(lsb <= 655) >= 0.99


# -- the Tacotron decoder-step kernel ---------------------------------------

SMALL_TACO = TacotronConfig(embed_dims=32, encoder_dims=32, decoder_dims=64,
                            lstm_dims=128, postnet_dims=32, encoder_K=4,
                            postnet_K=2, num_highways=1)


# narrow enough for the whole int8_lstm decoder to fit one CTA (143,584
# bytes of shared memory at L = 24)
ONE_CTA_TACO = TacotronConfig(embed_dims=32, encoder_dims=16, decoder_dims=32,
                              lstm_dims=64, postnet_dims=32, encoder_K=4,
                              postnet_K=2, num_highways=1)


def taco_inputs(device, r, L, dtype=torch.bfloat16, int8_lstm=False,
                cfg=SMALL_TACO):
    """Packed weights and encoder outputs of a seeded small Tacotron."""
    model = taco_from_jax(init_variables(cfg, 0), cfg, device)
    x = np.random.default_rng(L).integers(1, cfg.num_chars, (1, L))
    with torch.no_grad():
        enc, encp = model.encode(torch.from_numpy(x).to(device))
    packed = pack_tts_weights(extract_tts_decode_weights(model), r,
                              cfg.n_mels, dtype=dtype, int8_lstm=int8_lstm)
    return packed, enc[0].contiguous(), encp[0].contiguous()


def taco_state(device, L, nonzero=False, c=SMALL_TACO):
    """The decoder state of ``c`` for a text of L symbols: zero, as a
    decode starts, or with the LSTMs' h and c drawn from a seeded numpy
    generator."""
    state = init_tts_decode_state(c.decoder_dims, c.lstm_dims, L, c.n_mels,
                                  device)
    if nonzero:
        rng = np.random.default_rng(23)
        for f in ("h1", "c1", "h2", "c2"):
            v = rng.uniform(-0.9, 0.9, c.lstm_dims).astype(np.float32)
            setattr(state, f, torch.from_numpy(v).to(device))
    return state


def taco_run(fn, packed, enc, encp, n, chunks, state=None):
    if state is None:
        state = taco_state(enc.device, enc.shape[0])
    outs = []
    for _ in range(chunks):
        *o, state = fn(packed, enc, encp, state, n // chunks)
        outs.append(o)
    return [torch.cat(x) for x in zip(*outs)] + [state]


@pytest.mark.parametrize("grid", [None, 7], ids=["all_sms", "grid7"])
@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("L", [24, 200], ids=["short", "long"])
@pytest.mark.parametrize("r", [1, 2, 7])
def test_tts_kernel_matches_plain_version(cuda_device, r, L, chunks, grid,
                                          monkeypatch):
    """One CTA per SM (at D = 64 most CTAs own no GRU unit, and at L = 24
    most own no text position) and 7 CTAs (each owning many units of each
    phase)."""
    monkeypatch.setattr(cuda_tts, "CTAS", grid)
    packed, enc, encp = taco_inputs(cuda_device, r, L)
    n = cuda_tts.tts_decode.launches
    got = taco_run(cuda_tts.tts_decode, packed, enc, encp, 96, chunks)
    torch.cuda.synchronize()
    assert cuda_tts.tts_decode.launches == n + chunks
    want = taco_run(tts_decode_reference, packed, enc, encp, 96, chunks)
    assert got[0].shape == (96, r, 80) and got[1].shape == (96, L)
    for name, a, b in zip(("mels", "scores", "stop"), got[:3], want[:3]):
        d = (a - b).abs()
        print(f"grid {grid or 'all SMs'} r {r} L {L} chunks {chunks} "
              f"{name}: max|d| {float(d.max()):.3g}")
        assert float(d[:64].max()) <= 1e-3
        assert float((d <= 2e-2).float().mean()) >= 0.99
        assert torch.isfinite(a).all()
    for f in STATE_FIELDS:
        d = (getattr(got[3], f) - getattr(want[3], f)).abs()
        assert float(d.max()) <= 2e-2, f


@pytest.mark.parametrize("state_in", ["zero", "nonzero"])
@pytest.mark.parametrize("grid", [None, 1, 7, 37],
                         ids=["all_sms", "grid1", "grid7", "grid37"])
def test_tts_int8_lstm_kernel_matches_plain_version(cuda_device, grid,
                                                    state_in, monkeypatch):
    """The int8_lstm variant against its plain version over two 48-step
    launches (h and c carried in the state): the operands' maxima and the
    int8 sums are exact, so they agree to the bit.  At H = 128 7 CTAs own
    18 or 19 units of each LSTM, 37 CTAs 3 or 4 (as 132 CTAs do at H =
    512), one CTA per SM 0 or 1; one CTA owns all 64 of the narrower
    ONE_CTA_TACO (SMALL_TACO's decoder does not fit one CTA).  Step 0's h
    half comes from the state in: all zero (``quant_byte``'s zero path) or
    drawn; the spans launch gives the same bits."""
    monkeypatch.setattr(cuda_tts, "CTAS", grid)
    cfg = ONE_CTA_TACO if grid == 1 else SMALL_TACO
    packed, enc, encp = taco_inputs(cuda_device, 2, 24, int8_lstm=True,
                                    cfg=cfg)
    nonzero = state_in == "nonzero"
    n = (cuda_tts.tts_decode.launches, cuda_tts.tts_decode.launches_int8_lstm)
    run = lambda p, *a: cuda_tts.tts_decode(p, *a, int8_lstm=True)
    got = taco_run(run, packed, enc, encp, 96, 2,
                   taco_state(cuda_device, 24, nonzero, cfg))
    torch.cuda.synchronize()
    assert (cuda_tts.tts_decode.launches,
            cuda_tts.tts_decode.launches_int8_lstm) == (n[0] + 2, n[1] + 2)
    want = taco_run(tts_decode_reference, packed, enc, encp, 96, 2,
                    taco_state(cuda_device, 24, nonzero, cfg))
    for name, a, b in zip(("mels", "scores", "stop"), got[:3], want[:3]):
        print(f"int8_lstm grid {grid or 'all SMs'} state {state_in} {name}: "
              f"max|d| {float((a - b).abs().max()):.3g}")
        assert torch.equal(a, b), name
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got[3], f), getattr(want[3], f)), f
    spans_run = lambda p, *a: cuda_tts.tts_decode_spans(p, *a)[0]
    spanned = taco_run(spans_run, packed, enc, encp, 96, 2,
                       taco_state(cuda_device, 24, nonzero, cfg))
    torch.cuda.synchronize()
    assert cuda_tts.tts_decode.launches == n[0] + 2
    for a, b in zip(spanned[:3], got[:3]):
        assert torch.equal(a, b)


# an LSTM wider than 1,024: phase 2's threads load [h1 | h2] (H / 2 = 520
# float4) in more than two float4 each, and a row is 65 16-byte chunks
WIDE_LSTM_TACO = TacotronConfig(embed_dims=32, encoder_dims=32,
                                decoder_dims=64, lstm_dims=1040,
                                postnet_dims=32, encoder_K=4, postnet_K=2,
                                num_highways=1)


def test_tts_int8_lstm_kernel_takes_a_wide_lstm(cuda_device):
    """The int8_lstm variant at H = 1,040 on one CTA per SM, from a drawn
    state, over two 48-step launches: bit-equal to its plain version."""
    cfg = WIDE_LSTM_TACO
    packed, enc, encp = taco_inputs(cuda_device, 2, 24, int8_lstm=True,
                                    cfg=cfg)
    run = lambda p, *a: cuda_tts.tts_decode(p, *a, int8_lstm=True)
    got = taco_run(run, packed, enc, encp, 96, 2,
                   taco_state(cuda_device, 24, True, cfg))
    torch.cuda.synchronize()
    want = taco_run(tts_decode_reference, packed, enc, encp, 96, 2,
                    taco_state(cuda_device, 24, True, cfg))
    for name, a, b in zip(("mels", "scores", "stop"), got[:3], want[:3]):
        print(f"int8_lstm H 1040 {name}: "
              f"max|d| {float((a - b).abs().max()):.3g}")
        assert torch.equal(a, b), name
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got[3], f), getattr(want[3], f)), f


def test_tts_spans_stamp_every_phase_of_every_step(cuda_device):
    """The spans instantiation computes what the kernel computes and stamps
    the clock, in increasing order, at the end of each of a step's ten
    phases; it is not counted."""
    packed, enc, encp = taco_inputs(cuda_device, 2, 24)
    c = SMALL_TACO
    state = lambda: init_tts_decode_state(c.decoder_dims, c.lstm_dims, 24,
                                          c.n_mels, cuda_device)
    n = cuda_tts.tts_decode.launches
    (mels, scores, stop, _), spans = cuda_tts.tts_decode_spans(
        packed, enc, encp, state(), 8)
    assert cuda_tts.tts_decode.launches == n
    want = cuda_tts.tts_decode(packed, enc, encp, state(), 8)
    torch.cuda.synchronize()
    assert torch.equal(mels, want[0]) and torch.equal(scores, want[1])
    assert torch.equal(stop, want[2])
    t = spans.cpu().numpy().reshape(-1)
    assert spans.shape == (8, cuda_tts.PHASES_PER_STEP) == (8, 10)
    assert (t > 0).all()
    assert (np.diff(t) >= 0).all() and t[-1] > t[0]


def close_to_plain(got, want, tag):
    """chip_smoke.py's criteria: mels and scores within 1e-3 over the first
    64 steps, at least 99% of values within 2e-2, all finite."""
    for name, a, b in zip(("mels", "scores", "stop"), got[:3], want[:3]):
        d = (a - b).abs()
        print(f"{tag} {name}: max|d| {float(d.max()):.3g}")
        assert float(d[:64].max()) <= 1e-3, name
        assert float((d <= 2e-2).float().mean()) >= 0.99, name
        assert torch.isfinite(a).all(), name


def test_tts_kernel_raises_for_a_text_that_does_not_fit(cuda_device):
    """A text past the shared placement's limit on one CTA per SM at this
    width (``cuda_tts.shared_text_limit``: 13,328 symbols on 132 CTAs; the
    24-symbol text repeated to 13,344) no longer raises but decodes in the
    global placement, equal to the plain version."""
    packed, enc, encp = taco_inputs(cuda_device, 2, 24)
    c = SMALL_TACO
    grid = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    reps = cuda_tts.shared_text_limit(c.decoder_dims, c.decoder_dims // 2,
                                      c.lstm_dims, c.n_mels, 2, grid) // 24 + 1
    L = 24 * reps
    enc, encp = enc.repeat(reps, 1), encp.repeat(reps, 1)
    plan = cuda_tts.tts_smem_plan(c.decoder_dims, c.decoder_dims // 2,
                                  c.lstm_dims, c.n_mels, 2, L, grid)
    assert plan["placement"] == "global"
    n = cuda_tts.tts_decode.launches
    got = taco_run(cuda_tts.tts_decode, packed, enc, encp, 96, 2)
    torch.cuda.synchronize()
    assert cuda_tts.tts_decode.launches == n + 2
    close_to_plain(got, taco_run(tts_decode_reference, packed, enc, encp, 96,
                                 2), f"L {L}")


def test_tts_int8_lstm_kernel_decodes_past_its_shared_limit(cuda_device):
    """int8_lstm at full width one symbol past its shared placement's
    limit (``cuda_tts.shared_text_limit``: 3,828 on 132 CTAs): the global
    placement, bit-equal to the plain version, as the shared one is."""
    cfg = TacotronConfig()
    model = taco_from_jax(init_variables(cfg, 0), cfg, cuda_device)
    grid = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    L = cuda_tts.shared_text_limit(cfg.decoder_dims, cfg.decoder_dims // 2,
                                   cfg.lstm_dims, cfg.n_mels, 2, grid,
                                   True) + 1
    x = np.random.default_rng(L).integers(1, cfg.num_chars, (1, L))
    with torch.no_grad():
        enc, encp = model.encode(torch.from_numpy(x).to(cuda_device))
    enc, encp = enc[0].contiguous(), encp[0].contiguous()
    packed = pack_tts_weights(extract_tts_decode_weights(model), 2,
                              cfg.n_mels, int8_lstm=True)
    plan = cuda_tts.tts_smem_plan(cfg.decoder_dims, cfg.decoder_dims // 2,
                                  cfg.lstm_dims, cfg.n_mels, 2, L, grid,
                                  int8_lstm=True)
    assert plan["placement"] == "global"
    state = lambda: init_tts_decode_state(cfg.decoder_dims, cfg.lstm_dims, L,
                                          cfg.n_mels, cuda_device)
    n = cuda_tts.tts_decode.launches_int8_lstm
    got = cuda_tts.tts_decode(packed, enc, encp, state(), 48, int8_lstm=True)
    torch.cuda.synchronize()
    assert cuda_tts.tts_decode.launches_int8_lstm == n + 1
    want = tts_decode_reference(packed, enc, encp, state(), 48)
    close_to_plain(got, want, f"int8_lstm L {L}")
    for name, a, b in zip(("mels", "scores", "stop"), got[:3], want[:3]):
        assert torch.equal(a, b), name
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got[3], f), getattr(want[3], f)), f


@pytest.mark.parametrize("int8_lstm", [False, True], ids=["bf16", "int8_lstm"])
@pytest.mark.parametrize("grid", [None, 7], ids=["all_sms", "grid7"])
def test_tts_global_placement_equals_shared(cuda_device, grid, int8_lstm,
                                            monkeypatch):
    """The same short text in both placements (pinned through
    ``_launch``'s ``placement``): the same ownership, phase order and sums,
    so the same bits; and each against the plain version."""
    monkeypatch.setattr(cuda_tts, "CTAS", grid)
    packed, enc, encp = taco_inputs(cuda_device, 2, 200, int8_lstm=int8_lstm)
    outs = {}
    for placement in ("shared", "global"):
        run = lambda p, *a: cuda_tts._launch(p, *a, None,
                                             placement=placement)[0]
        outs[placement] = taco_run(run, packed, enc, encp, 96, 2)
    torch.cuda.synchronize()
    for a, b in zip(outs["shared"][:3], outs["global"][:3]):
        assert torch.equal(a, b)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(outs["shared"][3], f),
                           getattr(outs["global"][3], f)), f
    close_to_plain(outs["global"], taco_run(tts_decode_reference, packed,
                                            enc, encp, 96, 2),
                   f"global grid {grid or 'all SMs'} int8_lstm {int8_lstm}")
    # the spans instantiation of each placement: the same bits, stamps that
    # increase
    for placement in ("shared", "global"):
        stamps = []

        def spans_run(p, e, ep, st, n):
            t = torch.zeros(n, cuda_tts.PHASES_PER_STEP, dtype=torch.int64,
                            device=e.device)
            stamps.append(t)
            return cuda_tts._launch(p, e, ep, st, n, t,
                                    placement=placement)[0]
        spanned = taco_run(spans_run, packed, enc, encp, 96, 2)
        torch.cuda.synchronize()
        for a, b in zip(spanned[:3], outs[placement][:3]):
            assert torch.equal(a, b), placement
        t = torch.cat(stamps).cpu().numpy().reshape(-1)
        assert (t > 0).all() and (np.diff(t) >= 0).all()


def drawn_attention(state, seed):
    """``state`` with its cumulative and previous attention drawn from a
    seeded numpy generator: prv a distribution over the text, cum a
    running sum of earlier ones."""
    rng = np.random.default_rng(seed)
    L = state.cum.shape[0]
    prv = rng.dirichlet(np.full(L, 0.5)).astype(np.float32)
    cum = (prv + rng.uniform(0.0, 3.0, L)).astype(np.float32)
    state.prv = torch.from_numpy(prv).to(state.prv.device)
    state.cum = torch.from_numpy(cum).to(state.cum.device)
    return state


@pytest.mark.parametrize("int8_lstm", [False, True], ids=["bf16", "int8_lstm"])
@pytest.mark.parametrize("grid,L", [(7, 700), (None, 2_048), (7, 20)],
                         ids=["grid7_L700", "all_sms_L2048", "grid7_L20"])
def test_tts_long_text_path_is_placement_free(cuda_device, grid, L,
                                              int8_lstm, monkeypatch):
    """The path that grows with the text (the conv a block of positions at
    a time over each CTA's window of cum and prv, the energies a warp a
    position, the context split over warps) from a drawn state whose cum
    and prv are nonzero, over two chained 48-step launches: both
    placements give the same bits, and the kernel holds to its plain
    version (int8_lstm every value equal).  Grid 7 at L = 700: 100
    positions a CTA, 13 a conv slot; one CTA per SM at L = 2,048: a
    context column over 8 warps; grid 7 at L = 20: windows past both ends
    of the text."""
    monkeypatch.setattr(cuda_tts, "CTAS", grid)
    packed, enc, encp = taco_inputs(cuda_device, 2, L, int8_lstm=int8_lstm)
    state = lambda: drawn_attention(taco_state(cuda_device, L, True), L)
    outs = {}
    for placement in ("shared", "global"):
        run = lambda p, *a: cuda_tts._launch(p, *a, None,
                                             placement=placement)[0]
        outs[placement] = taco_run(run, packed, enc, encp, 96, 2, state())
    torch.cuda.synchronize()
    for a, b in zip(outs["shared"][:3], outs["global"][:3]):
        assert torch.equal(a, b)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(outs["shared"][3], f),
                           getattr(outs["global"][3], f)), f
    want = taco_run(tts_decode_reference, packed, enc, encp, 96, 2, state())
    close_to_plain(outs["global"], want,
                   f"L {L} grid {grid or 'all SMs'} int8_lstm {int8_lstm}")
    if int8_lstm:
        for a, b in zip(outs["global"][:3], want[:3]):
            assert torch.equal(a, b)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(outs["global"][3], f),
                               getattr(want[3], f)), f


def test_tts_kernel_rejects_what_it_does_not_take(cuda_device):
    packed, enc, encp = taco_inputs(cuda_device, 2, 24)
    c = SMALL_TACO
    state = init_tts_decode_state(c.decoder_dims, c.lstm_dims, 24, c.n_mels,
                                  cuda_device)
    with pytest.raises(ValueError, match="int8_lstm"):
        cuda_tts.tts_decode(packed, enc, encp, state, 4, int8_lstm=True)
    f32, _, _ = taco_inputs(cuda_device, 2, 24, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_tts.tts_decode(f32, enc, encp, state, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_tts.tts_decode(packed, enc.t().contiguous().t(), encp, state, 4)
    bad = dict(packed, whh=packed["whh"].t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_tts.tts_decode(bad, enc, encp, state, 4)
    with pytest.raises(ValueError, match="packed"):
        cuda_tts.tts_decode({k: t.cpu() for k, t in packed.items()}, enc,
                            encp, state, 4)
    with pytest.raises(ValueError, match="encp"):
        cuda_tts.tts_decode(packed, enc, encp.double(), state, 4)


def test_tts_generator_on_card_passes_the_tts_gate(cuda_device):
    """The trained tiny golden through the kernel: one launch per 48-step
    chunk, and the bench's TTS gate holds."""
    meta = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())
    blob = load_pytree(GOLDEN / "tiny_tacotron.msgpack")
    gen = TTSGenerator(TacotronConfig(**meta["dims"]),
                       {"params": blob["params"],
                        "batch_stats": blob["batch_stats"]},
                       cuda_device, steps=400, stop_patience=6)
    assert gen.backend == "kernel"
    seq = text_to_sequence(meta["eval_text"], ["english_cleaners"])
    n = cuda_tts.tts_decode.launches
    mel, _, attn = gen(seq, r=meta["r"])
    steps = mel.shape[1] // meta["r"]
    assert cuda_tts.tts_decode.launches - n == (steps + 47) // 48
    gt = np.load(GOLDEN / "tiny_tacotron_gt_mel.npy") * 8.0 - 4.0
    g = tts_gates(mel, attn, len(seq), gt)
    assert gates_pass(g, meta["pinned_gates_cpu_xla"]["mel_gt_l1"]), g


# -- text serving over both kernels and Griffin-Lim --------------------------

def tiny_tts_pipeline(device, **kw):
    """The tiny golden Tacotron into a seeded small MOL vocoder on
    ``device``, deterministic, int16 out."""
    from wavernn_tpu_torch.infer.pipeline import TTSPipeline

    meta = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())
    blob = load_pytree(GOLDEN / "tiny_tacotron.msgpack")
    cfg, model = small("MOL")
    kw = {"deterministic": True, "output_dtype": "int16", "tts_steps": 400,
          **kw}
    return TTSPipeline(TacotronConfig(**meta["dims"]),
                       {"params": blob["params"],
                        "batch_stats": blob["batch_stats"]},
                       cfg, to_jax_variables(model), ["english_cleaners"],
                       r=meta["r"], device=device, **kw)


def test_http_service_serves_through_both_kernels_on_card(cuda_device):
    """/synthesize and /stream through the daemon: both kernels launch,
    and under deterministic decode the two bodies are byte-equal."""
    import http.client
    import threading

    from wavernn_tpu_torch.infer.http_server import (SynthesisService,
                                                     make_http_server)

    service = SynthesisService(tiny_tts_pipeline(cuda_device), target=200,
                               overlap=28, mu_law=False, group=4, width=16,
                               capacity=2, slot_seconds=2.0,
                               chunk_timeout=120.0)
    httpd = make_http_server(service, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    bodies = {}
    try:
        n_voc, n_tts = cuda_decode.decode.launches, cuda_tts.tts_decode.launches
        for path in ("/synthesize", "/stream"):
            conn = http.client.HTTPConnection("127.0.0.1",
                                              httpd.server_address[1],
                                              timeout=120)
            conn.request("POST", path,
                         body=json.dumps({"text": "abcdeabcde"}).encode())
            resp = conn.getresponse()
            bodies[path] = resp.read()
            conn.close()
            assert resp.status == 200, bodies[path][:200]
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    assert cuda_decode.decode.launches > n_voc + 1
    assert cuda_tts.tts_decode.launches >= n_tts + 2
    one, streamed = bodies["/synthesize"][44:], bodies["/stream"][44:]
    assert len(one) > 0 and len(one) % (2 * 275) == 0
    assert one == streamed


def test_two_stage_server_equals_solo_streams_on_card(cuda_device):
    from wavernn_tpu_torch.infer.pipeline import mel_from_linear
    from wavernn_tpu_torch.infer.stream_server import TTSStreamServer

    pipe = tiny_tts_pipeline(cuda_device)
    texts = ["abcdeabcde", "abcde", "edcba"]
    kw = dict(target=200, overlap=28, mu_law=False)
    solo = [np.concatenate(list(pipe.voc.stream(mel_from_linear(
        pipe.tts(text_to_sequence(t, ["english_cleaners"]), r=2)[1]),
        group=4, **kw))) for t in texts]
    srv = TTSStreamServer(pipe, group=4, width=16, capacity=2,
                          slot_seconds=2.0, **kw)
    for got, want in zip(srv.run(texts), solo):
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want)
    assert srv.server.launches < sum(-(-len(w) // 228 // 4) for w in solo)


def test_griffinlim_on_card_matches_cpu(cuda_device):
    """The same NNLS and Griffin-Lim on the card and on the CPU from one
    initial phase, within 1e-3 relative RMS."""
    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.dsp import torch_audio

    hp.reset()
    hp.configure(Path(__file__).parent.parent / "hparams.py")
    try:
        mel = np.load(Path(__file__).parent.parent / "bench_assets"
                      / "golden_eval_mel.npy")[:, :200]
        S = torch_audio.mel_to_linear(mel, cuda_device)
        S_cpu = torch_audio.mel_to_linear(mel, "cpu")
        phase = torch.rand(S.shape, device=cuda_device) * (2 * np.pi)
        with torch.no_grad():
            a = torch_audio.griffinlim(S, phase, 16, 275, 1100).cpu()
            b = torch_audio.griffinlim(S_cpu, phase.cpu(), 16, 275, 1100)
        assert a.shape == b.shape == (199 * 275,)
        assert float((a - b).norm() / b.norm()) <= 1e-3
        wav = torch_audio.reconstruct_waveform(mel, n_iter=4,
                                               device=cuda_device)
        assert wav.shape == (199 * 275,) and np.isfinite(wav).all()
    finally:
        hp.reset()


def train_batch(cfg, B, rng):
    """A teacher-forcing batch at the model's hop (4 mel frames + pads)."""
    T = 4 * cfg.hop_length
    mels = rng.uniform(0, 1, (B, 4 + 2 * cfg.pad, cfg.feat_dims))
    if cfg.mode == "RAW":
        y = rng.integers(0, 2 ** cfg.bits, (B, T + 1))
        return ((2 * y[:, :-1] / (2 ** cfg.bits - 1) - 1).astype(np.float32),
                y[:, 1:], mels.astype(np.float32))
    y = rng.uniform(-1, 1, (B, T + 1)).astype(np.float32)
    return y[:, :-1], y[:, 1:], mels.astype(np.float32)


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_train_step_on_card_matches_cpu(cuda_device, mode):
    """Two clipped Adam steps of one seeded model on the card (cuDNN's GRU,
    TF32 off) and on the CPU: the first loss within 1e-5 relative and the
    second within 1e-4, the BatchNorm statistics after the first step
    within 1e-5, every weight after both within 6*lr + 1e-6."""
    from wavernn_tpu_torch.training.state import make_optimizer, \
        new_train_state
    from wavernn_tpu_torch.training.wavernn import make_train_step

    cfg, model = small(mode)
    states, losses, stats = [], [], []
    for dev in (cuda_device, torch.device("cpu")):
        m = WaveRNN(cfg)
        m.load_state_dict(model.state_dict())
        opt = make_optimizer(1e-3, 0.5)
        state = new_train_state(m.to(dev), opt)
        step = make_train_step(opt, mode)
        rng = np.random.default_rng(0)
        losses.append([float(step(state, *train_batch(cfg, 3, rng))[1])])
        stats.append({n: b.cpu().double() for n, b in m.named_buffers()
                      if "running" in n})
        losses[-1].append(float(step(state, *train_batch(cfg, 3, rng))[1]))
        states.append(state)
    (card1, card2), (cpu1, cpu2) = losses
    assert abs(card1 - cpu1) <= 1e-5 * abs(cpu1)
    assert abs(card2 - cpu2) <= 1e-4 * abs(cpu2)
    for name, t in stats[1].items():
        assert float((stats[0][name] - t).abs().max()) <= 1e-5, name
    card, cpu = (dict(s.model.named_parameters()) for s in states)
    for name, t in cpu.items():
        d = (card[name].detach().cpu().double() - t.detach().double())
        assert float(d.abs().max()) <= 6e-3 + 1e-6, name


@pytest.mark.parametrize("cudnn_mode", ["default", "deterministic"])
def test_train_gradients_on_card_are_float32_accurate(cuda_device,
                                                      cudnn_mode):
    """The full-width MOL step's gradients (B=4 x 1,375) in float32 on the
    card, with every ReLU mask pinned to the float64 forward's, are each
    within 1e-5 relative L2 of float64: no convolution, GEMM or cuDNN GRU
    algorithm on the card loses float32 accuracy.  The plain float32 step
    flips a mask or two at fc1/fc2 where rounding crosses zero, and that
    alone moves the conditioning network's gradients by up to 5e-4."""
    from chip_smoke import relu_masks
    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.ops.mol import discretized_mix_logistic_loss

    hp.reset()
    hp.configure(Path(__file__).parent.parent / "hparams.py")
    try:
        cfg = WaveRNNConfig.from_hp(hp)
        T = hp.voc_seq_len
    finally:
        hp.reset()
    rng = np.random.default_rng(0)
    y = rng.uniform(-1, 1, (4, T + 1))
    mels = rng.uniform(0, 1, (4, T // cfg.hop_length + 2 * cfg.pad,
                              cfg.feat_dims))

    def gradients(dt, **masks):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = WaveRNN(cfg).to(cuda_device, dt).train()
        x, t, m = (torch.tensor(a, dtype=dt, device=cuda_device)
                   for a in (y[:, :-1], y[:, 1:], mels))
        with relu_masks(**masks):
            discretized_mix_logistic_loss(model(x, m), t).backward()
        return {n: p.grad.double() for n, p in model.named_parameters()}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = cudnn_mode == "deterministic"
    try:
        ref, seen = [], []
        g64 = gradients(torch.float64, record=ref)
        plain = gradients(torch.float32, record=seen)
        pinned = gradients(torch.float32, pinned=ref)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rel = {n: float((pinned[n] - g).norm() / g.norm())
           for n, g in g64.items()}
    assert max(rel.values()) <= 1e-5, max(rel.items(), key=lambda kv: kv[1])
    flips = [int((a != b).sum()) for a, b in zip(seen, ref)]
    assert max(float((plain[n] - g).norm() / g.norm())
               for n, g in g64.items()) <= 5e-4, flips


def test_gen_testset_goes_through_the_kernel(cuda_device, tmp_path):
    """Audition generation at a checkpoint vocodes each held-out utterance
    with one decode-kernel launch and writes int16 WAVs of its length."""
    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.infer.wavernn import gen_testset
    from wavernn_tpu_torch.training.state import make_optimizer, \
        new_train_state

    hp.reset()
    hp.configure(Path(__file__).parent.parent / "hparams.py",
                 voc_mode="MOL")
    try:
        cfg, model = small("MOL")
        state = new_train_state(model.to(cuda_device),
                                make_optimizer(1e-4, 4.0))
        rng = np.random.default_rng(0)
        test_set = [(rng.uniform(0, 1, (80, 21)).astype(np.float32),
                     rng.integers(0, 2 ** 16, 20 * 275)) for _ in range(3)]
        n = cuda_decode.decode.launches
        out = gen_testset(cfg, state, test_set, 2, True, 1100, 275, tmp_path)
        torch.cuda.synchronize()
        assert cuda_decode.decode.launches == n + 2
        assert len(out) == 2
        for p in out:
            pcm = np.frombuffer(p.read_bytes()[44:], "<i2")
            assert pcm.shape == (20 * 275,) and pcm.std() > 0
        assert len(list(tmp_path.glob("*_target.wav"))) == 2
    finally:
        hp.reset()


# -- data parallelism (parallel/) --------------------------------------


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_row0_shard_draws_the_rows_of_the_whole_launch(cuda_device, mode):
    """A launch over rows [k, k+b) with row0 = k draws the whole launch's
    bits for those rows (sampling), and equals its plain version."""
    cfg, model = small(mode)
    packed = packed_on(model, cfg, cuda_device, True)
    cond = conditioning(cfg, 8, 64, cuda_device)
    whole = cuda_decode.decode(packed, cond, 64, 5, mode, cfg.n_classes,
                               False)
    part = cond[3:7].contiguous()
    got = cuda_decode.decode(packed, part, 64, 5, mode, cfg.n_classes,
                             False, row0=3)
    want = cuda_decode.decode_reference(packed, part, 64, 5, mode,
                                        cfg.n_classes, False, row0=3)
    assert torch.equal(got, whole[3:7]) and torch.equal(got, want)


@pytest.mark.parametrize("det", [False, True])
def test_generator_mesh_on_one_card_equals_meshless(cuda_device, det):
    """Two shards on one card, the Generator asked for the bare "cuda":
    one decode launch per shard, and the meshless Generator's bytes."""
    from wavernn_tpu_torch.models.wavernn import to_jax_variables
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.parallel.mesh import make_mesh

    cfg, model = small("MOL")
    v = to_jax_variables(model)
    mel = np.random.default_rng(2).uniform(0, 1, (80, 9)).astype(np.float32)
    kw = dict(fold_bucket=4, deterministic=det, input_dtype="float16",
              output_dtype="int16")
    geom = dict(batched=True, target=200, overlap=28, mu_law=False, seed=6)
    want = Generator(cfg, v, "cuda", **kw)(mel, **geom)
    gen = Generator(cfg, v, "cuda",
                    mesh=make_mesh(devices=["cuda", "cuda"]), **kw)
    gen(mel, **geom)                               # calibrates int8_ff
    n = cuda_decode.decode.launches
    got = gen(mel, **geom)
    assert cuda_decode.decode.launches == n + 2
    assert got.dtype == np.int16 and np.array_equal(got, want)


def test_bf16_gru_on_card_matches_plain(cuda_device):
    """``compute_dtype="bfloat16"`` on the card: ``ops.rnn.low_product``
    (cuBLAS's bf16 GEMM with float32 output) against its plain version
    (the float32 matmul of the rounded operands) at the hoisted input
    projection's shape, within 1e-5 of the largest |value| (the products
    are exact, the float32 sums' order differs); then the bf16 GRU
    sequence (``gru_sequence_low``, 512 wide, 8 x 64 steps) on each
    product: outputs within 1e-3 relative L2 and every gradient within
    5e-3, as a state element's bf16 rounding may flip where the two
    float32 sums straddle a boundary (``tests/test_torch_bf16_train.py``
    holds the CPU against JAX to the same bounds)."""
    from wavernn_tpu_torch.models.wavernn import GRUCell, gru_sequence_low
    from wavernn_tpu_torch.ops.rnn import low_product, low_product_reference

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(4096, 544, generator=gen).to(cuda_device).bfloat16()
    b = (0.04 * torch.randn(544, 1536, generator=gen)).to(
        cuda_device).bfloat16()
    want = low_product_reference(a, b)
    got = low_product(a, b)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        cell = GRUCell(544, 512).to(cuda_device)
    x = torch.randn(8, 64, 544, generator=gen).to(cuda_device)
    cot = torch.randn(8, 64, 512, generator=gen).to(cuda_device)
    outs = []
    for product in (low_product, low_product_reference):
        cell.zero_grad()
        xg = x.clone().requires_grad_()
        ys = gru_sequence_low(cell, xg, "bfloat16", product)
        (ys * cot).sum().backward()
        outs.append([ys.detach(), xg.grad] + [p.grad.clone() for p in
                                              cell.parameters()])
    rel = lambda u, v: float((u - v).norm() / v.norm())
    assert rel(outs[0][0], outs[1][0]) <= 1e-3
    for u, v in zip(outs[0][1:], outs[1][1:]):
        assert rel(u, v) <= 5e-3
