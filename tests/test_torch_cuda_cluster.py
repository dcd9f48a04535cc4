"""The decode kernel's cluster design (``ops/csrc/decode_cluster.cu``) on
the card, held against its plain version ``cuda_decode.decode_reference``.

Every test here needs an NVIDIA GPU with the CUDA toolkit, carries the
``cuda`` marker and skips elsewhere.  The module imports no JAX:

    python -m pytest --noconftest tests/test_torch_cuda_cluster.py -m cuda -q

The models are the committed golden MOL (``bench_assets/
wavernn_mol_golden.msgpack``, full width) and the tiny RAW golden
(``tests/golden/tiny_wavernn_raw.msgpack``), on their own conditioning
(the golden eval mel; the tiny golden's mel), rows tiled where a test asks
for more fold rows than the mel has.  Each variant (int8 recurrent
matrices on and off, int8 feed-forward matrices on and off), deterministic
and sampling, at 1, 3 and 48 rows x 1,024 steps, 240 rows x 64 steps and
with ``row0`` != 0; ``int8_gates`` (each operand quantized at its row's
scale from the CTAs' exchanged maxima) at 1, 16 and 48 rows x 1,024
steps, 240 rows x 64 steps, uneven widths and ``row0`` != 0.  Tolerances
are ``chip_smoke.py`` phase 3's: the first 64 steps within 1e-3 and at
least 99% of samples within 2e-2 (deterministic), the first 64 steps
within 1e-2 (sampling); every max |d| is printed (0 so far: both sum the
exact bf16 products in float64 and the int8 products exactly).
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.models.wavernn import WaveRNN, WaveRNNConfig
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.ops.decode import Generator, extract_decode_weights
from wavernn_tpu_torch.utils.checkpoints import load_pytree

REPO = Path(__file__).resolve().parents[1]
MODELS = {
    "golden MOL": (WaveRNNConfig(), REPO / "bench_assets"
                   / "wavernn_mol_golden.msgpack",
                   REPO / "bench_assets" / "golden_eval_mel.npy",
                   (11_000, 550)),
    "tiny RAW": (WaveRNNConfig(rnn_dims=32, fc_dims=32, compute_dims=16,
                               res_out_dims=16, res_blocks=2, mode="RAW"),
                 REPO / "tests" / "golden" / "tiny_wavernn_raw.msgpack",
                 REPO / "tests" / "golden" / "tiny_wavernn_raw_mel.npy",
                 (1000, 12)),
}

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    """The first CUDA device; skips where there is none (decided at test
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    set_float32_policy()
    return torch.device("cuda", 0)


_CACHE = {}


def model_inputs(dev, model, int8_hh):
    """(cfg, {variant: pack}, conditioning (rows, 1024 steps)) of a model,
    its int8 feed-forward bounds calibrated on its mel; ``int8_gates``'
    pack beside them (it calibrates nothing)."""
    key = (model, int8_hh)
    if key not in _CACHE:
        cfg, weights, mel_path, (target, overlap) = MODELS[model]
        blob = load_pytree(weights)
        v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
        gen = Generator(cfg, v, device=dev, fold_bucket=16, int8_hh=int8_hh,
                        int8_ff=True)
        staged = gen.prestage(np.load(mel_path), batched=True, target=target,
                              overlap=overlap)
        gen._ensure_ff_scales(staged.mels_dev, 16)
        cond = gen.fold_conditioning(staged)[0][:, :1024].contiguous()
        gates = cuda_decode.pack_weights(gen.weights, cfg.feat_dims,
                                         cfg.aux_dims, int8_gates=True)
        _CACHE[key] = (cfg, {"bf16 ff": gen.packed, "int8_ff": gen.packed_ff,
                             "int8_gates": gates}, cond)
    return _CACHE[key]


def rows_of(cond, B):
    """B fold rows of ``cond``, tiled where it has fewer."""
    reps = -(-B // cond.shape[0])
    return torch.cat([cond] * reps)[:B].contiguous()


def hold(tag, packed, cond, T, cfg, det, row0=0):
    """The cluster kernel against the plain version; returns max |d|."""
    seed = 0 if det else 1234
    n = (cuda_decode.decode.launches, cuda_decode.decode.launches_cluster)
    got = cuda_decode.decode(packed, cond, T, seed, cfg.mode, cfg.n_classes,
                             det, row0=row0)
    torch.cuda.synchronize()
    assert (cuda_decode.decode.launches,
            cuda_decode.decode.launches_cluster) == (n[0] + 1, n[1] + 1)
    want = cuda_decode.decode_reference(packed, cond, T, seed, cfg.mode,
                                        cfg.n_classes, det, row0=row0)
    d = (got - want).abs()
    print(f"cluster vs plain [{tag}] rows {cond.shape[0]} steps {T} row0 "
          f"{row0}: max|d| {float(d.max()):.3g}")
    assert torch.isfinite(got).all() and got.abs().max() <= 1.0
    if det:
        assert float(d[:, :64].max()) <= 1e-3
        assert float((d <= 2e-2).float().mean()) >= 0.99
    else:
        assert float(d[:, :64].max()) <= 1e-2
    return float(d.max())


@pytest.mark.parametrize("B", [1, 3, 48])
@pytest.mark.parametrize("det", [True, False], ids=["argmax", "sampling"])
@pytest.mark.parametrize("ff", ["int8_ff", "bf16 ff"])
@pytest.mark.parametrize("int8_hh", [True, False], ids=["int8_hh", "bf16_hh"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_cluster_kernel_matches_plain_version(cuda_device, model, int8_hh,
                                              ff, det, B):
    cfg, packs, cond = model_inputs(cuda_device, model, int8_hh)
    hold(f"{model} {'int8_hh' if int8_hh else 'bf16 hh'} {ff}", packs[ff],
         rows_of(cond, B), 1024, cfg, det)


@pytest.mark.parametrize("B", [1, 16, 48])
@pytest.mark.parametrize("det", [True, False], ids=["argmax", "sampling"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_cluster_int8_gates_matches_plain_version(cuda_device, model, det,
                                                  B):
    """int8_gates on the cluster design: every operand's row scale from
    the K CTAs' maxima, handed over with the float32 operand."""
    cfg, packs, cond = model_inputs(cuda_device, model, True)
    hold(f"{model} int8_gates", packs["int8_gates"], rows_of(cond, B), 1024,
         cfg, det)


@pytest.mark.parametrize("det", [True, False], ids=["argmax", "sampling"])
@pytest.mark.parametrize("ff", ["int8_ff", "bf16 ff", "int8_gates"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_cluster_kernel_at_240_rows(cuda_device, model, ff, det):
    """Five co-batched 24 s requests' rows: a narrower cluster, or more
    rows a cluster, than at 48."""
    cfg, packs, cond = model_inputs(cuda_device, model, True)
    hold(f"{model} int8_hh {ff}", packs[ff], rows_of(cond, 240)[:, :64]
         .contiguous(), 64, cfg, det)


@pytest.mark.parametrize("ff", ["int8_ff", "bf16 ff", "int8_gates"])
def test_row0_keys_the_bits_of_the_whole_launch(cuda_device, ff):
    """A launch over rows [row0, row0 + b) draws what the whole launch
    draws for them (a mesh shard), in sampling mode."""
    cfg, packs, cond = model_inputs(cuda_device, "golden MOL", True)
    cond = rows_of(cond, 16)[:, :256].contiguous()
    whole = cuda_decode.decode(packs[ff], cond, 256, 9, "MOL", 30, False)
    for row0, b in ((5, 3), (8, 8)):
        hold(f"golden MOL int8_hh {ff}", packs[ff],
             cond[row0:row0 + b].contiguous(), 256, cfg, False, row0=row0)
        part = cuda_decode.decode(packs[ff], cond[row0:row0 + b].contiguous(),
                                  256, 9, "MOL", 30, False, row0=row0)
        assert torch.equal(part, whole[row0:row0 + b])


@pytest.mark.parametrize("int8_hh", [True, False], ids=["int8_hh", "bf16"])
@pytest.mark.parametrize("width,mode", [(48, "MOL"), (80, "RAW")])
def test_cluster_kernel_uneven_widths_match_exactly(cuda_device, width,
                                                    mode, int8_hh):
    """H = F = 48 or 80: three or five 16-unit groups over a cluster of 2
    or 4 (owned ranges of unequal length), an odd K0 = 80 + 9, 5 rows.
    Held to max |d| 0 in both decode modes."""
    cfg = WaveRNNConfig(rnn_dims=width, fc_dims=width, compute_dims=32,
                        res_out_dims=36, res_blocks=2, mode=mode)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = WaveRNN(cfg).eval()
    packed = cuda_decode.pack_weights(extract_decode_weights(model),
                                      cfg.feat_dims, cfg.aux_dims,
                                      int8_hh=int8_hh)
    packed = {k: (t.to(cuda_device) if t is not None else None)
              for k, t in packed.items()}
    cond = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (5, 200, cfg.feat_dims + cfg.res_out_dims)).astype(
            np.float32)).to(torch.bfloat16).to(cuda_device)
    for det in (True, False):
        assert hold(f"width {width} {mode}", packed, cond, 200, cfg,
                    det) == 0.0


@pytest.mark.parametrize("width,mode", [(48, "MOL"), (80, "RAW")])
def test_cluster_int8_gates_uneven_widths_match_exactly(cuda_device, width,
                                                         mode):
    """int8_gates at H = F = 48 or 80 (owned ranges of unequal length, so
    the CTAs' maxima cover slices of unequal length), an odd K0, 5 rows:
    max |d| 0 in both decode modes."""
    cfg = WaveRNNConfig(rnn_dims=width, fc_dims=width, compute_dims=32,
                        res_out_dims=36, res_blocks=2, mode=mode)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = WaveRNN(cfg).eval()
    packed = cuda_decode.pack_weights(extract_decode_weights(model),
                                      cfg.feat_dims, cfg.aux_dims,
                                      int8_gates=True)
    packed = {k: (t.to(cuda_device) if t is not None else None)
              for k, t in packed.items()}
    cond = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (5, 200, cfg.feat_dims + cfg.res_out_dims)).astype(
            np.float32)).to(torch.bfloat16).to(cuda_device)
    for det in (True, False):
        assert hold(f"width {width} {mode} int8_gates", packed, cond, 200,
                    cfg, det) == 0.0


def test_kernel_layout_equals_the_plan(cuda_device):
    """The kernel's own layout bytes equal the plan's for every variant,
    width and row count the tests run (and a few more)."""
    from wavernn_tpu_torch.ops.build import load_library

    lib = load_library()
    variants = [(i8, ff, False) for i8 in (True, False)
                for ff in (True, False)] + [(True, True, True)]
    for H, F, feat, d, n_out in ((512, 512, 80, 32, 30),
                                 (32, 32, 80, 4, 512)):
        for i8, ff, g8 in variants:
            for B in (1, 3, 16, 48, 132, 240, 400):
                plan = cuda_decode.pick_cluster_plan(
                    B, H, F, feat, d, n_out, i8, ff,
                    lambda k: cuda_decode.max_clusters(
                        lib, cuda_device, k, i8, ff, g8), g8)
                dims = [H, F, feat, d, n_out, int(i8), int(ff), plan["K"],
                        plan["rows"], plan["rc"], plan["budget"], int(g8)]
                got = lib.wavernn_decode_cluster_bytes(
                    (ctypes.c_longlong * len(dims))(*dims))
                assert got == plan["bytes"], (H, i8, ff, g8, B, plan)
    # int8_gates without int8 matrices is no plan the kernel takes
    dims = [512, 512, 80, 32, 30, 0, 1, 16, 1, 1, 65536, 1]
    assert lib.wavernn_decode_cluster_bytes(
        (ctypes.c_longlong * len(dims))(*dims)) == -1


def test_refused_launch_raises_and_nothing_falls_back(cuda_device,
                                                      monkeypatch):
    """A plan the kernel does not take raises with the card's error; the
    wrapper neither retries on the row design nor runs the plain version."""
    cfg, packs, cond = model_inputs(cuda_device, "golden MOL", True)
    cond = rows_of(cond, 4)[:, :64].contiguous()
    real = cuda_decode._cluster_dims

    def bad(*args):
        dims = real(*args)
        dims[18] = 1          # one cluster for four rows of one a cluster
        return dims

    monkeypatch.setattr(cuda_decode, "_cluster_dims", bad)
    n = (cuda_decode.decode.launches, cuda_decode.decode.launches_cluster)
    for pack in ("int8_ff", "int8_gates"):
        with pytest.raises(RuntimeError, match="cluster design"):
            cuda_decode.decode(packs[pack], cond, 64, 1, "MOL", 30, False)
    assert (cuda_decode.decode.launches,
            cuda_decode.decode.launches_cluster) == n


def test_generator_serves_through_the_cluster_kernel(cuda_device):
    """A mel request through ``Generator``: one cluster launch, none of
    the row design."""
    cfg, weights, mel_path, _ = MODELS["golden MOL"]
    blob = load_pytree(weights)
    gen = Generator(cfg, {"params": blob["params"],
                          "batch_stats": blob["batch_stats"]},
                    device=cuda_device, fold_bucket=16)
    mel = np.load(mel_path)[:, :200]
    gen(mel, batched=True, target=2750, overlap=550, mu_law=False)   # warm
    n = (cuda_decode.decode.launches, cuda_decode.decode.launches_cluster)
    wav = gen(mel, batched=True, target=2750, overlap=550, mu_law=False)
    assert np.isfinite(wav).all() and wav.shape == (199 * cfg.hop_length,)
    assert (cuda_decode.decode.launches - n[0],
            cuda_decode.decode.launches_cluster - n[1]) == (1, 1)


def test_int8_gates_generator_serves_through_the_cluster_kernel(cuda_device):
    """``Generator(int8_gates=True)``: one launch, int8_gates' and the
    cluster design's."""
    cfg, weights, mel_path, _ = MODELS["golden MOL"]
    blob = load_pytree(weights)
    gen = Generator(cfg, {"params": blob["params"],
                          "batch_stats": blob["batch_stats"]},
                    device=cuda_device, fold_bucket=16, int8_gates=True)
    mel = np.load(mel_path)[:, :200]
    d = cuda_decode.decode
    n = (d.launches, d.launches_cluster, d.launches_int8_gates)
    wav = gen(mel, batched=True, target=2750, overlap=550, mu_law=False)
    assert np.isfinite(wav).all() and wav.shape == (199 * cfg.hop_length,)
    assert (d.launches - n[0], d.launches_cluster - n[1],
            d.launches_int8_gates - n[2]) == (1, 1, 1)
