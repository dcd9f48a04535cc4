"""The decode kernel's cluster design on the CPU: its plan
(``cuda_decode.cluster_plan``, ``pick_cluster_plan``) and the wrapper's
route between the two designs.

The kernel (``ops/csrc/decode_cluster.cu``) splits each fold row's output
columns over a thread-block cluster of K CTAs and computes the same layout
as the plan; the wrapper refuses a launch where they differ (held on the
card by ``tests/test_torch_cuda_cluster.py``).  Here, at the full-size MOL
widths and the tiny RAW golden's, for 1 to 241 fold rows and 8, 16 or 33
co-resident clusters, for every variant (``int8_gates`` included): every
GRU unit and FC column is owned exactly once in a cluster, in ranges
aligned to the kernel's 16-byte loads and balanced within one group; the
rows fit in one wave; the layout (``int8_gates``' float32 operands, int8
plane and per-CTA maxima included) fits a CTA's shared memory, or the plan
raises with the numbers.  No JAX: the plan is pure Python, and the route's
plain version is ``decode_reference``.
"""

import pytest
import torch

from wavernn_tpu_torch.models.wavernn import WaveRNN, WaveRNNConfig
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.ops.cuda_decode import (
    SMEM_LIMIT, cluster_plan, cluster_size, design_for, pick_cluster_plan,
)
from wavernn_tpu_torch.ops.decode import extract_decode_weights
from tests.torch_cpu import one_torch_thread  # noqa: F401

# (H, F, feat, aux_d, n_out): hparams.py's MOL model and the tiny RAW golden
WIDTHS = {"full MOL": (512, 512, 80, 32, 30), "tiny RAW": (32, 32, 80, 4, 512)}
# name -> (int8_hh, int8_ff, int8_gates)
VARIANTS = {"int8_hh+int8_ff": (True, True, False),
            "int8_hh": (True, False, False),
            "bf16+int8_ff": (False, True, False),
            "bf16": (False, False, False),
            "int8_gates": (False, False, True)}
# an H100's co-resident clusters of K CTAs, one CTA an SM (measured by
# cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3)
H100_CLUSTERS = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}


def align16(n):
    return -(-n // 16) * 16


def operand_regions(H, F, rows, K, int8_hh, int8_ff, int8_gates):
    """The operand buffers' bytes, written out apart from the plan: the
    h1 operands (two, by step parity), h2, the A and B operands, and
    int8_gates' int8 plane, maxima (five operands, a word a row and CTA)
    and five operands' row scales."""
    W = max(H, F)
    hsz = 4 if int8_gates else 1 if int8_hh else 8
    fsz = 4 if int8_gates else 1 if int8_ff else 8
    want = {"h1": 2 * align16(H * rows * hsz), "h2": align16(H * rows * hsz),
            "a": align16(W * rows * fsz), "b": align16(W * rows * fsz)}
    if int8_gates:
        want.update({"int8 plane": align16(W * rows),
                     "maxima": align16(5 * rows * K * 4),
                     "row scales": align16(5 * rows * 4)})
    return want


def check_ranges(ranges, n, group, most):
    """Contiguous ranges covering [0, n) once, aligned to ``group``,
    balanced within one group, none longer than ``most``."""
    owner = [0] * n
    for start, stop in ranges:
        assert start % group == 0 and stop % group == 0
        assert 0 <= start < stop <= n and stop - start <= most
        for j in range(start, stop):
            owner[j] += 1
    assert owner == [1] * n
    sizes = [stop - start for start, stop in ranges]
    assert max(sizes) - min(sizes) <= group
    assert most - max(sizes) < group


@pytest.mark.parametrize("max_clusters", [8, 16, 33])
@pytest.mark.parametrize("B", [1, 3, 16, 48, 132, 240, 241])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_plan_owns_every_unit_once_in_one_wave(widths, variant, B,
                                               max_clusters):
    H, F, feat, d, n_out = WIDTHS[widths]
    int8_hh, int8_ff, int8_gates = VARIANTS[variant]
    args = (B, H, F, feat, d, n_out, int8_hh, int8_ff, max_clusters)
    try:
        plan = cluster_plan(*args, int8_gates=int8_gates)
    except ValueError as e:
        # only a layout past a CTA's shared memory raises, with its numbers
        whole = cluster_plan(*args, limit=10 ** 9, budget=2048,
                             int8_gates=int8_gates)
        assert whole["bytes"] > SMEM_LIMIT
        assert f"{B} fold rows" in str(e) and str(SMEM_LIMIT) in str(e)
        return
    K, rows, rc, clusters = (plan[k] for k in ("K", "rows", "rc",
                                               "clusters"))
    # int8_gates' five big matrices are int8: its dots are int8_hh's and
    # int8_ff's
    int8_hh, int8_ff = int8_hh or int8_gates, int8_ff or int8_gates
    assert K == cluster_size(H, F, int8_ff)
    gF = 16 if int8_ff else 8
    assert len(plan["units"]) == len(plan["fc"]) == K
    check_ranges(plan["units"], H, 16, plan["U"])
    check_ranges(plan["fc"], F, gF, plan["Fo"])
    # one wave: every row in a co-resident cluster, no cluster idle
    assert rows % rc == 0 and rc in (1, 2)
    assert rows * clusters >= B > rows * (clusters - 1)
    assert clusters <= max_clusters
    # the layout: 16-byte aligned regions inside a CTA's shared memory
    assert plan["bytes"] == sum(plan["regions"].values()) <= SMEM_LIMIT
    assert all(n % 16 == 0 for n in plan["regions"].values())
    want = operand_regions(H, F, rows, K, int8_hh, int8_ff, int8_gates)
    assert {k: plan["regions"].get(k) for k in want} == want
    assert ("maxima" in plan["regions"]) == int8_gates
    assert all(o % 16 == 0 for o in plan["offsets"].values())
    for name, (S, L) in plan["splits"].items():
        assert S >= 1 and L >= 1
    # an int8 dot's slices are whole packed words (4 k rows)
    for name in ("hh1", "hh2") if int8_hh else ():
        assert plan["splits"][name][1] % 4 == 0
    for name in ("ih2", "fc1", "fc2") if int8_ff else ():
        assert plan["splits"][name][1] % 4 == 0


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_plan_covers_every_k_row(widths):
    H, F, feat, d, n_out = WIDTHS[widths]
    plan = cluster_plan(48, H, F, feat, d, n_out, True, True, 16)
    K0 = feat + d
    rows = dict(im1=K0, im=K0, hh1=H, ih2=H, aux2=d, hh2=H, fc1=H, aux3=d,
                fc2=F, aux4=d, fc3=plan["Fo"])
    for name, (S, L) in plan["splits"].items():
        assert (S - 1) * L < rows[name] <= S * L, name


def test_cluster_size_follows_the_widths():
    assert cluster_size(512, 512, True) == 16
    assert cluster_size(32, 32, True) == 2      # the tiny RAW golden
    assert cluster_size(64, 64, False) == 4     # the card tests' model
    assert cluster_size(48, 48, False) == 2     # three 16-unit groups
    with pytest.raises(ValueError, match="H >= 16"):
        cluster_size(8, 8, False)


def test_plan_raises_when_nothing_fits():
    H, F, feat, d, n_out = WIDTHS["full MOL"]
    with pytest.raises(ValueError, match=r"241 fold rows .* 232448"):
        cluster_plan(241, H, F, feat, d, n_out, True, True, 1)
    with pytest.raises(ValueError, match="power of two"):
        cluster_plan(4, H, F, feat, d, n_out, True, True, 8, K=3)
    with pytest.raises(ValueError, match="multiple of 16"):
        cluster_plan(4, 520, F, feat, d, n_out, True, True, 8)
    with pytest.raises(ValueError, match="no cluster plan fits"):
        pick_cluster_plan(4, H, F, feat, d, n_out, True, True, lambda k: 0)


def test_pick_takes_the_widest_cluster_in_the_fewest_waves():
    H, F, feat, d, n_out = WIDTHS["full MOL"]
    at = H100_CLUSTERS.__getitem__
    # the main path: a 24 s request (48 rows) on clusters of 16
    plan = pick_cluster_plan(48, H, F, feat, d, n_out, True, True, at)
    assert (plan["K"], plan["waves"]) == (16, 1)
    assert plan["clusters"] <= at(16)
    # five co-batched requests: a narrower cluster, still one wave
    plan = pick_cluster_plan(240, H, F, feat, d, n_out, True, True, at)
    assert plan["waves"] == 1 and plan["clusters"] <= at(plan["K"])
    assert plan["K"] < 16
    # more rows than any one-wave layout holds: more waves, every row kept
    plan = pick_cluster_plan(1000, H, F, feat, d, n_out, True, True, at)
    assert plan["waves"] > 1
    assert plan["rows"] * plan["clusters"] >= 1000
    assert plan["waves"] == -(-plan["clusters"] // at(plan["K"]))


@pytest.fixture(scope="module")
def small():
    cfg = WaveRNNConfig(rnn_dims=64, fc_dims=64, compute_dims=32,
                        res_out_dims=32, res_blocks=2, mode="MOL")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = WaveRNN(cfg).eval()
    w = extract_decode_weights(model)
    g = torch.Generator().manual_seed(1)
    cond = torch.rand(3, 40, cfg.feat_dims + cfg.res_out_dims,
                      generator=g).to(torch.bfloat16)
    packs = {
        "int8_hh": cuda_decode.pack_weights(w, cfg.feat_dims, cfg.aux_dims),
        "int8_ff": cuda_decode.pack_weights(
            w, cfg.feat_dims, cfg.aux_dims, int8_ff=True,
            ff_scales=[2.0, 2.5, 3.0]),
        "int8_gates": cuda_decode.pack_weights(w, cfg.feat_dims, cfg.aux_dims,
                                               int8_gates=True),
    }
    return cfg, packs, cond


def counts():
    d = cuda_decode.decode
    return (d.launches, d.launches_cluster, d.launches_int8_ff,
            d.launches_int8_gates)


@pytest.mark.parametrize("design", [None, "cluster", "row"])
@pytest.mark.parametrize("pack", ["int8_hh", "int8_ff", "int8_gates"])
def test_cpu_tensors_run_the_plain_version(small, pack, design):
    cfg, packs, cond = small
    n = counts()
    got = cuda_decode.decode(packs[pack], cond, 40, 5, "MOL", cfg.n_classes,
                             False, design=design)
    want = cuda_decode.decode_reference(packs[pack], cond, 40, 5, "MOL",
                                        cfg.n_classes, False)
    assert torch.equal(got, want)
    assert counts() == n               # no kernel on the CPU


def test_int8_gates_and_ablations_take_the_row_design(small):
    """The route: int8_gates defaults to the cluster design (and takes the
    row design only when asked, the A/B arm); an ablation defaults to the
    row design and raises on the cluster design."""
    cfg, packs, cond = small
    args = (cond, 40, 5, "MOL", cfg.n_classes, True)
    assert design_for(packs["int8_gates"]) == "cluster"
    assert design_for(packs["int8_gates"], design="row") == "row"
    assert design_for(packs["int8_ff"]) == "cluster"
    assert design_for(packs["int8_hh"], frozenset({"gates"})) == "row"
    with pytest.raises(ValueError, match="cluster design"):
        cuda_decode.decode(packs["int8_hh"], *args, design="cluster",
                           ablate=frozenset({"gates"}))
    with pytest.raises(ValueError, match="cluster design"):
        design_for(packs["int8_hh"], frozenset({"sample"}), "cluster")
    with pytest.raises(ValueError, match="design must be one of"):
        cuda_decode.decode(packs["int8_hh"], *args, design="tiles")
    with pytest.raises(ValueError, match="row design's"):
        cuda_decode.decode(packs["int8_hh"], *args, design="cluster",
                           rows_per_cta=2)
    # either default runs as its plain version on the CPU
    got = cuda_decode.decode(packs["int8_gates"], *args)
    assert torch.equal(got, cuda_decode.decode_reference(
        packs["int8_gates"], *args))
    got = cuda_decode.decode(packs["int8_hh"], *args,
                             ablate=frozenset({"sample"}))
    assert torch.equal(got, cuda_decode.decode_reference(
        packs["int8_hh"], *args, ablate=frozenset({"sample"})))

