"""The WaveRNN sample loop as hand-written CUDA kernels for Hopper.

Counterpart of ``wavernn_tpu/ops/pallas_decode.py``: the same packed
weights (without the TPU's 128-lane padding), the same per-step math, and a
plain PyTorch version of that math (:func:`decode_reference`) that the CPU
tests hold against the JAX kernel and that ``chip_smoke.py`` holds the CUDA
kernel against on the card.

Per step and fold row the kernel computes, where ``@`` is a dot of bf16
operands whose exact products are summed in float64 and rounded to f32:

    seg0 = [mel | a1], seg1 = [a2 | a3 | a4]     (one bf16 conditioning row)
    gi1  = x*u1 + seg0 @ w_Im1                   (gru1 inputs precomposed
    xi   = x*w_x + seg0 @ w_Im + b_I              through the I layer)
    h1   = gru(gi1, h1 @ w_hh1)                  (int8 or bf16 w_hh1)
    xr   = xi + h1
    h2   = gru(ff(xr, 0) @ w_ih2x + seg1 @ w_aux[:, :3H], h2 @ w_hh2)
    xr   = xr + h2
    f1   = relu(ff(xr, 1) @ w_fc1x + seg1 @ w_aux[:, 3H:3H+F] + b_fc1)
    f2   = relu(ff(f1, 2) @ w_fc2x + seg1 @ w_aux[:, 3H+F:] + b_fc2)
    logits = bf(f2) @ w_fc3 + b_fc3
    x    = sample(logits)                        (RAW or MOL, drawn or modal)

``ff(a, i)`` is ``bf(a)`` with bf16 feed-forward matrices.  With int8 ones
(the TPU kernel's ``int8_ff``), it is ``round(clip(a * ffq[i], +-127))``
(half to even) at the calibrated multiplier ``ffq = 127 / S``, the dot sums
the int8 products exactly, and its sum is multiplied by the column's fused
scale ``*_fs`` (weight scale x S / 127).

With ``int8_gates`` (the TPU kernel's variant of that name) the five big
matrices (``w_hh1``, ``w_ih2x``, ``w_hh2``, ``w_fc1x``, ``w_fc2x``) are int8
with per-column scales ``*_s``, and each of their operands (h1, xr, h2, xr
after GRU2, relu(f1)) is quantized per row on the fly: ``sa = max(max|a|,
1e-8) * (1/127)``, ``qa = round(a / sa)`` (a true division, half to even),
the int32 sum times ``(sa * s_w)``.  A pack records its variant by its
scale names: ``*_s`` of all five matrices (``int8_gates``), ``*_fs``
(``int8_ff``), or ``w_hh1_s`` / ``w_hh2_s`` alone (``int8_hh``);
:func:`variant` reads them.

The TPU kernel's random bits (``pltpu.prng_*``) become a counter-based hash
of (seed, fold row, step, lane), so the plain version reproduces the
kernel's draws exactly and a sampling-mode run compares as a trajectory.
The fold row is ``row0`` plus the row within the launch: a launch over
rows ``[row0, row0 + B)`` of a larger batch (one shard of a mesh) draws
the bits the whole batch's launch draws for them, so a sharded decode
equals the unsharded one bit for bit in sampling mode too.

``ablate`` (dev only, for ``tools/kernel_breakdown.py``) drops named pieces
of the step, with the JAX kernel's meanings: ``"gates"`` makes each GRU
update ``0.5*h + 0.01*(gi[:, :H] + gh[:, :H])``, ``"cond_read"`` reads a
zero conditioning row, ``"sample"`` makes ``tanh(logits[:, 0])`` the sample
and the next x, and ``"out_write"`` stores no output (which is then
unspecified).

The kernel has two designs (:func:`decode`'s ``design``).  ``"cluster"``
(``csrc/decode_cluster.cu``, the default for every variant, ``int8_gates``
included; not the ablations): a fold row's output columns are split over a
thread-block cluster of K CTAs, each streaming 1/K of the weights a step,
the operands of the next phase exchanged through distributed shared
memory; :func:`cluster_plan` lays it out.  ``int8_gates`` hands its
operands over as float32 with each CTA's per-row maxima, and every CTA
quantizes the whole operand behind the same barrier.  ``"row"``
(``csrc/decode.cu``): one CTA owns ``rows_per_cta`` fold rows and streams
every weight; it is the ablations' route and the A/B arm.
"""

from __future__ import annotations

import ctypes
import math
from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from wavernn_tpu_torch.ops.decode import DecodeWeights

LOG_SCALE_MIN = float(math.log(1e-14))
_MODES = {"RAW": 0, "MOL": 1}
# The row design's fold rows per CTA (its ablations and int8_gates are
# built for this one: ABLATION_R in csrc/decode.cu).  Measured on an H100
# (700 W) at 64 rows x 2,048 steps with int8_hh: 72.94 us/step at 1 (1,024
# threads), more than twice that at 2 (512 threads; PERF.md): a CTA builds
# each weight's double once for its R rows, but its float64 FMAs grow with
# R and it has half the threads.  Up to 132 rows (one CTA per SM) one row
# per CTA is faster.  The cluster design sets its rows per cluster itself
# (:func:`cluster_plan`).
ROWS_PER_CTA = 1
DESIGNS = ("cluster", "row")
# the kernel's ablation bits (AB_* in csrc/decode.cu), and the masks it is
# built for: production (0) and the breakdown's five
ABLATIONS = {"sample": 1, "gates": 2, "cond_read": 4, "out_write": 8}
KERNEL_ABLATIONS = (frozenset(), frozenset({"sample"}), frozenset({"gates"}),
                    frozenset({"sample", "gates"}), frozenset({"cond_read"}),
                    frozenset({"out_write"}))

# pointer order of the C entry point after (cond, out)
WEIGHT_ORDER = (
    "w_Im1", "u1", "w_Im", "w_x", "b_I",
    "w_hh1", "w_hh1_s", "b1", "b_hh1_n",
    "w_ih2x", "w_hh2", "w_hh2_s", "b2", "b_hh2_n",
    "w_fc1x", "b_fc1", "w_fc2x", "b_fc2",
    "w_aux", "w_fc3", "b_fc3",
    "w_ih2x_fs", "w_fc1x_fs", "w_fc2x_fs", "ffq",
    "w_ih2x_s", "w_fc1x_s", "w_fc2x_s",
)


def q8(mat: torch.Tensor):
    """Per-column symmetric int8: (rows, N) -> (int8 (rows, N), f32 (N,))."""
    mat = mat.float()
    m = mat.abs().amax(dim=0)
    s = torch.where(m > 0, m, torch.ones_like(m)) / 127.0
    return torch.round(mat / s).to(torch.int8), s


def pack_weights(w: DecodeWeights, feat: int, aux_d: int,
                 int8_hh: bool = True, int8_ff: bool = False,
                 ff_scales=None, int8_gates: bool = False) -> dict:
    """The kernel's weight set (``pallas_decode.pack_weights`` without the
    lane padding).  Conditioning rows are [mel | a1 | a2 | a3 | a4]:
    ``w_Im``/``w_Im1`` take the first feat+aux_d of them, the fused
    ``w_aux`` the last 3*aux_d, with columns [gru2 (3H) | fc1 (F) | fc2 (F)]
    and each block's rows at its own aux stream (zero elsewhere).

    ``int8_ff`` stores the three feed-forward matrices (GRU2's ``w_ih[:H]``,
    FC1's ``w[:H]``, FC2's ``w[:F]``) as per-column int8, each with its
    scale fused with its operand's calibrated bound, ``*_fs = s_w * (S *
    (1/127))`` in float32 (the reference's order), and adds ``ffq = 127 /
    S``: ``ff_scales`` is the (3,) bound S of [xr after GRU1, xr after
    GRU2, relu(fc1)] (:func:`ops.decode.ff_ranges`); it raises without
    them.

    ``int8_gates`` stores the five big matrices (both ``w_hh``, GRU2's
    ``w_ih[:H]``, FC1's ``w[:H]``, FC2's ``w[:F]``) as per-column int8 with
    their raw scales ``*_s``, whatever ``int8_hh`` says (as the JAX pack
    does); it is exclusive with ``int8_ff``."""
    bf = lambda a: a.to(torch.bfloat16).contiguous()
    f32 = lambda a: a.float().contiguous()
    H = w.gru1_w_hh.shape[0]
    F = w.fc1_w.shape[1]

    def gru_bias(b_ih, b_hh):
        b = torch.cat([b_ih[:H] + b_hh[:H], b_ih[H:2 * H] + b_hh[H:2 * H],
                       b_ih[2 * H:]])
        return f32(b), f32(b_hh[2 * H:])

    b1, b_hh1_n = gru_bias(w.gru1_b_ih.float(), w.gru1_b_hh.float())
    b2, b_hh2_n = gru_bias(w.gru2_b_ih.float(), w.gru2_b_hh.float())

    # gru1's input gates precomposed through the linear I layer, in f32,
    # then cast: gi1 = x*(w_x @ w_ih1) + seg0 @ (w_Im @ w_ih1) + b_I @ w_ih1
    ih1 = w.gru1_w_ih.float()
    I_w = w.I_w.float()
    u1 = I_w[0] @ ih1
    w_Im1 = I_w[1:] @ ih1
    b1 = f32(b1 + w.I_b.float() @ ih1)

    if int8_gates and int8_ff:
        raise ValueError("int8_gates is exclusive with int8_ff")
    if int8_hh or int8_gates:
        w_hh1, w_hh1_s = q8(w.gru1_w_hh)
        w_hh2, w_hh2_s = q8(w.gru2_w_hh)
    else:
        w_hh1, w_hh1_s = bf(w.gru1_w_hh), None
        w_hh2, w_hh2_s = bf(w.gru2_w_hh), None

    ff = {}
    if int8_gates:
        for name, mat in (("w_ih2x", w.gru2_w_ih[:H]), ("w_fc1x", w.fc1_w[:H]),
                          ("w_fc2x", w.fc2_w[:F])):
            q, s = q8(mat)
            ff[name], ff[name + "_s"] = q.contiguous(), s.contiguous()
    elif int8_ff:
        if ff_scales is None:
            raise ValueError("int8_ff needs calibrated ff_scales")
        S = torch.as_tensor(ff_scales, dtype=torch.float32,
                            device=ih1.device)
        if S.shape != (3,):
            raise ValueError(f"ff_scales must be (3,), got {tuple(S.shape)}")
        s_act = S * (1.0 / 127.0)
        for i, (name, mat) in enumerate((("w_ih2x", w.gru2_w_ih[:H]),
                                         ("w_fc1x", w.fc1_w[:H]),
                                         ("w_fc2x", w.fc2_w[:F]))):
            q, s = q8(mat)
            ff[name] = q.contiguous()
            ff[name + "_fs"] = (s * s_act[i]).contiguous()
        # a true division (``127.0 / S`` would multiply by 1/S)
        ff["ffq"] = torch.full_like(S, 127.0) / S
    else:
        ff = dict(w_ih2x=bf(w.gru2_w_ih[:H]), w_fc1x=bf(w.fc1_w[:H]),
                  w_fc2x=bf(w.fc2_w[:F]))

    d = aux_d
    w_aux = torch.zeros(3 * d, 3 * H + 2 * F, dtype=torch.float32,
                        device=ih1.device)
    w_aux[0:d, :3 * H] = w.gru2_w_ih[H:].float()
    w_aux[d:2 * d, 3 * H:3 * H + F] = w.fc1_w[H:].float()
    w_aux[2 * d:3 * d, 3 * H + F:] = w.fc2_w[F:].float()

    return dict(
        w_Im1=bf(w_Im1), u1=f32(u1),
        w_Im=bf(I_w[1:]), w_x=f32(I_w[0]), b_I=f32(w.I_b),
        w_hh1=w_hh1.contiguous(), w_hh1_s=w_hh1_s, b1=b1, b_hh1_n=b_hh1_n,
        w_hh2=w_hh2.contiguous(), w_hh2_s=w_hh2_s, b2=b2, b_hh2_n=b_hh2_n,
        b_fc1=f32(w.fc1_b), b_fc2=f32(w.fc2_b),
        w_aux=bf(w_aux),
        w_fc3=bf(w.fc3_w), b_fc3=f32(w.fc3_b),
        **ff,
    )


def is_int8_gates(packed: dict) -> bool:
    """Whether a pack is ``int8_gates``'s (its marker: the raw scales of
    the int8 feed-forward matrices)."""
    return packed.get("w_ih2x_s") is not None


def is_int8_ff(packed: dict) -> bool:
    """Whether a pack holds int8 feed-forward matrices at calibrated
    bounds (``int8_ff``; its marker: the fused scales)."""
    return packed.get("w_ih2x_fs") is not None


def is_int8_hh(packed: dict) -> bool:
    """Whether a pack holds int8 recurrent matrices at the fixed state
    scale (``int8_hh``, beside bf16 or ``int8_ff`` feed-forward ones)."""
    return (packed["w_hh1"].dtype == torch.int8
            and not is_int8_gates(packed))


def variant(packed: dict) -> str:
    """The pack's kernel variant: ``"int8_gates"``, or its recurrent
    matrices (``"int8_hh"`` / ``"bf16"``) with ``"+int8_ff"`` where its
    feed-forward ones are int8."""
    if is_int8_gates(packed):
        return "int8_gates"
    return (("int8_hh" if is_int8_hh(packed) else "bf16")
            + ("+int8_ff" if is_int8_ff(packed) else ""))


def pack_stream(mels_up: torch.Tensor, aux_mel: torch.Tensor,
                total_scale: int) -> torch.Tensor:
    """(1, L, feat) sample-rate mels + (1, T_m, 4d) MEL-rate aux -> one
    (L, feat + 4d) bf16 conditioning stream [mel | a1 | a2 | a3 | a4], aux
    broadcast from mel rate."""
    a = torch.repeat_interleave(aux_mel[0], total_scale, dim=0)
    return torch.cat([mels_up[0], a], dim=-1).to(torch.bfloat16)


def fold_major_cond(packed: torch.Tensor, starts: torch.Tensor,
                    T: int) -> torch.Tensor:
    """(L, C) stream + (B,) fold start rows -> fold-major (B, T, C)
    conditioning: fold b is rows starts[b] .. starts[b]+T of the stream."""
    idx = starts[:, None] + torch.arange(T, device=packed.device)[None, :]
    return packed[idx].contiguous()


# -- random bits ----------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's 32-bit integer hash (``mix32`` in csrc/decode.cu)."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def random_bits(seed: int, rows: torch.Tensor, step: int,
                n_lanes: int, row0: int = 0) -> torch.Tensor:
    """uint32 bits (as int64) for (seed, row0 + row, step, lane): (B,
    n_lanes)."""
    dev = rows.device
    h = _mix32(torch.tensor((seed & _M32) ^ 0x9E3779B9, dtype=torch.int64,
                            device=dev))
    h = _mix32(h ^ ((rows.to(torch.int64) + row0) & _M32))[:, None]
    h = _mix32(h ^ step)
    lanes = torch.arange(n_lanes, dtype=torch.int64, device=dev)[None, :]
    return _mix32(h ^ lanes)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa trick, as ``pallas_decode._uniform_from_bits``: (0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0 + 1e-7


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(uniform_from_bits(bits)))


def _row_argmax(x: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B, 1) index of the first maximum."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device).expand_as(x)
    hit = torch.where(x >= x.amax(dim=-1, keepdim=True), idx, n)
    return hit.amin(dim=-1, keepdim=True)


# -- the plain version ----------------------------------------------------

def ablation_mask(ablate) -> int:
    """The kernel's bitmask for a set of ablation names; unknown names
    raise."""
    unknown = set(ablate) - set(ABLATIONS)
    if unknown:
        raise ValueError(f"unknown ablations {sorted(unknown)}; known: "
                         f"{sorted(ABLATIONS)}")
    return sum(ABLATIONS[a] for a in set(ablate))


def _check(packed: dict, cond: torch.Tensor, T: int, mode: str):
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if cond.dim() != 3 or cond.dtype != torch.bfloat16:
        raise ValueError(f"cond must be (B, T, C) bf16, got "
                         f"{tuple(cond.shape)} {cond.dtype}")
    if not 0 < T <= cond.shape[1]:
        raise ValueError(f"T={T} outside the conditioning's "
                         f"{cond.shape[1]} steps")
    d = packed["w_aux"].shape[0] // 3
    K0 = packed["w_Im"].shape[0]
    if cond.shape[2] != K0 + 3 * d:
        raise ValueError(f"cond width {cond.shape[2]} != {K0 + 3 * d}")


def decode_reference(packed: dict, cond: torch.Tensor, T: int, seed: int,
                     mode: str, n_classes: int, deterministic: bool,
                     ablate: frozenset = frozenset(),
                     row0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, T) float32 samples.

    Each dot takes bf16-valued operands (rounded to bf16, held in a wider
    type), whose products are exact; the products are summed in float64
    and the sum rounded once to float32, as the kernel does.  A float64
    sum of exact products hardly depends on the order of its terms, so the
    kernel and this version agree to the bit nearly always.  With float32
    sums they would not: the order decides the last bit of an activation,
    that bit decides its bf16 rounding at the next dot, and the trained
    model's sample loop carries such a difference forward.  The int8
    recurrent dot multiplies integers, exact while H*127**2 < 2**24.  The
    gate arithmetic is float32, one rounding per operation, in the
    kernel's order.  With int8 feed-forward matrices the operand is
    quantized as the module's docstring says (a float32 multiply, the
    clip, ``torch.round``: half to even, as ``rintf``) and the integer
    products are summed exactly, as the kernel's ``dp4a`` does.  With
    ``int8_gates`` each of the five operands is quantized at its row's
    scale in float32 (the row max, the clamp at 1e-8, the multiply by
    float32(1/127), a true division, ``torch.round``), the integer
    products are summed exactly (|sum| <= 127 * 127 * H < 2**24, so its
    float32 is exact) and the sum is multiplied by ``sa * s_w``.
    ``ablate`` and ``row0`` (the random bits' row of row 0) as in the
    module's docstring."""
    ablation_mask(ablate)
    _check(packed, cond, T, mode)
    f = {k: (v.float() if v is not None and v.dtype != torch.int8 else v)
         for k, v in packed.items()}
    int8_gates = is_int8_gates(packed)
    int8_ff = is_int8_ff(packed)
    int8_hh = is_int8_hh(packed)
    w64 = {k: packed[k].double() for k in (
        "w_Im1", "w_Im", "w_hh1", "w_ih2x", "w_hh2", "w_fc1x", "w_fc2x",
        "w_aux", "w_fc3")}
    B, _, C = cond.shape
    H = f["b_hh1_n"].shape[0]
    H3 = 3 * H
    F = f["b_fc1"].shape[0]
    K0 = f["w_Im"].shape[0]
    dev = cond.device
    bfr = lambda v: v.to(torch.bfloat16).float()
    mm = lambda a, name: (a.double() @ w64[name]).float()
    rows = torch.arange(B, device=dev)

    def gdot(a, name):
        """int8_gates: the operand quantized per row on the fly."""
        sa = torch.clamp(a.abs().amax(dim=1, keepdim=True),
                         min=1e-8) * (1.0 / 127.0)
        return mm(torch.round(a / sa), name) * (sa * f[name + "_s"])

    def gdot_h(h, name):
        if int8_gates:
            return gdot(h, name)
        if int8_hh:
            acc = mm(torch.round(h * 127.0), name)
            return acc * (f[name + "_s"] * (1.0 / 127.0))
        return mm(bfr(h), name)

    def gdot_ff(a, name, i):
        if int8_gates:
            return gdot(a, name)
        if int8_ff:
            qa = torch.round(torch.clamp(a * f["ffq"][i], -127.0, 127.0))
            return mm(qa, name) * f[name + "_fs"]
        return mm(bfr(a), name)

    def gates(gi, gh, h, b, b_hh_n):
        if "gates" in ablate:
            return 0.5 * h + 0.01 * (gi[:, :H] + gh[:, :H])
        sg = lambda v: 0.5 * torch.tanh(0.5 * v) + 0.5
        tot = gi + b
        r = sg(tot[:, :H] + gh[:, :H])
        z = sg(tot[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(tot[:, 2 * H:] + r * (gh[:, 2 * H:] + b_hh_n))
        return (1.0 - z) * n + z * h

    x = torch.zeros(B, 1, device=dev)
    h1 = torch.zeros(B, H, device=dev)
    h2 = torch.zeros(B, H, device=dev)
    out = torch.empty(B, T, device=dev)
    condf = cond.float()
    if "cond_read" in ablate:
        condf = torch.zeros_like(condf)
    for t in range(T):
        seg0, seg1 = condf[:, t, :K0], condf[:, t, K0:]
        aux_all = mm(seg1, "w_aux")
        gi1 = x * f["u1"] + mm(seg0, "w_Im1")
        xi = x * f["w_x"] + mm(seg0, "w_Im") + f["b_I"]
        h1 = gates(gi1, gdot_h(h1, "w_hh1"), h1, f["b1"], f["b_hh1_n"])
        xr = xi + h1
        gi2 = gdot_ff(xr, "w_ih2x", 0) + aux_all[:, :H3]
        h2 = gates(gi2, gdot_h(h2, "w_hh2"), h2, f["b2"], f["b_hh2_n"])
        xr = xr + h2
        f1 = torch.relu(gdot_ff(xr, "w_fc1x", 1) + aux_all[:, H3:H3 + F]
                        + f["b_fc1"])
        f2 = torch.relu(gdot_ff(f1, "w_fc2x", 2) + aux_all[:, H3 + F:]
                        + f["b_fc2"])
        logits = mm(bfr(f2), "w_fc3") + f["b_fc3"]

        if "sample" in ablate:
            sample = torch.tanh(logits[:, :1])
        elif mode == "RAW":
            scores = logits
            if not deterministic:
                scores = logits + gumbel_from_bits(
                    random_bits(seed, rows, t, logits.shape[1], row0))
            cls = _row_argmax(scores)
            # divide as the kernel does: multiply by the f32 reciprocal
            sample = 2.0 * cls.float() * (1.0 / (n_classes - 1.0)) - 1.0
        else:
            nm = n_classes // 3
            pi, mu = logits[:, :nm], logits[:, nm:2 * nm]
            ls = torch.clamp(logits[:, 2 * nm:3 * nm], min=LOG_SCALE_MIN)
            if deterministic:
                sel = _row_argmax(pi)
                sample = torch.gather(mu, 1, sel)
            else:
                bits = random_bits(seed, rows, t, nm + 1, row0)
                scores = pi + gumbel_from_bits(bits[:, :nm])
                hit = (scores >= scores.amax(dim=1, keepdim=True)).float()
                onehot = hit / hit.sum(dim=1, keepdim=True)
                mean = (mu * onehot).sum(dim=1, keepdim=True)
                log_scale = (ls * onehot).sum(dim=1, keepdim=True)
                u = torch.clamp(uniform_from_bits(bits[:, nm:]),
                                1e-5, 1.0 - 1e-5)
                sample = mean + torch.exp(log_scale) * (
                    torch.log(u) - torch.log(1.0 - u))
            sample = torch.clamp(sample, -1.0, 1.0)
        if "out_write" not in ablate:
            out[:, t] = sample[:, 0]
        x = sample
    return out


# -- the cluster design's plan ---------------------------------------------

CLUSTER_THREADS = 512      # threads per CTA (NT in csrc/decode_cluster.cu)
CLUSTER_KMAX = 16          # the largest cluster (non-portable past 8)
SMEM_LIMIT = 232_448       # shared memory one CTA may use on Hopper
# bytes one bf16 dot's partial sums may take, largest first: a larger
# budget splits k finer (shorter chains of L2 round trips)
DOT_BUDGETS = (65_536, 32_768, 16_384, 8_192, 4_096, 2_048)
# the step's dots, in csrc/decode_cluster.cu's order
CLUSTER_DOTS = ("im1", "im", "hh1", "ih2", "aux2", "hh2", "fc1", "aux3",
                "fc2", "aux4", "fc3")
# the window (1-4) each dot is computed in for the next step, between the
# arrival at that cluster barrier and the wait there; 0: in its phase
CLUSTER_WINDOW = dict(im1=1, im=1, hh1=2, ih2=0, aux2=2, hh2=3, fc1=0,
                      aux3=3, fc2=0, aux4=4, fc3=0)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def dot_split(K: int, G: int, nt: int, align: int, smax: int,
              min_rows: int) -> tuple:
    """``dot::split`` of ``csrc/dot.cuh``: (S slices, L rows each) of a
    K-row dot with G column tasks a slice over ``nt`` threads."""
    if K <= 0:
        return 1, align
    S = nt // G if G > 0 else 1
    S = max(1, min(S, K // min_rows, smax))
    L = -(-K // S)
    L = -(-L // align) * align
    return -(-K // L), L


def owned(n_groups: int, group: int, cta: int, K: int) -> tuple:
    """[start, stop) of the columns CTA ``cta`` of a cluster of ``K`` owns:
    a balanced share of ``n_groups`` groups of ``group`` columns."""
    return (group * (cta * n_groups // K),
            group * ((cta + 1) * n_groups // K))


def cluster_size(H: int, F: int, int8_ff: bool) -> int:
    """The widest cluster the widths take: every CTA owns at least one
    16-unit GRU group and one FC group (16 columns with int8 feed-forward
    matrices, else 8), at most :data:`CLUSTER_KMAX` CTAs."""
    n = min(H // 16, F // (16 if int8_ff else 8), CLUSTER_KMAX)
    if n < 1:
        raise ValueError(f"the cluster kernel takes H >= 16 and F >= "
                         f"{16 if int8_ff else 8}, got H={H}, F={F}")
    return 1 << (n.bit_length() - 1)


def cluster_plan(B: int, H: int, F: int, feat: int, aux_d: int, n_out: int,
                 int8_hh: bool, int8_ff: bool, max_clusters: int,
                 K: int | None = None, limit: int = SMEM_LIMIT,
                 budget: int | None = None,
                 int8_gates: bool = False) -> dict:
    """The cluster kernel's plan for ``B`` fold rows on clusters of ``K``
    CTAs (default :func:`cluster_size`), of which ``max_clusters`` are
    co-resident on the card (one CTA an SM): ``rows`` per cluster so that
    ``clusters`` x ``rows`` >= B in one wave, ``rc`` rows a task, each
    CTA's GRU units and FC columns, each dot's split and the place of its
    sums, and the shared-memory ``bytes`` every CTA allocates (the kernel
    computes the same layout and refuses a launch whose plan disagrees).
    ``budget`` caps the bytes of one bf16 dot's partial sums (default: the
    largest of :data:`DOT_BUDGETS` whose layout fits).  ``int8_gates``
    makes all five big dots int8 (``int8_hh`` and ``int8_ff`` are then
    implied), holds their operands as float32 and adds the int8 plane and
    the five operands' maxima (a word a row and CTA) and row scales.
    Raises ``ValueError`` with the numbers when the layout exceeds
    ``limit`` bytes."""
    int8_hh = int8_hh or int8_gates
    int8_ff = int8_ff or int8_gates
    if budget is None:
        for b in DOT_BUDGETS[:-1]:
            try:
                return cluster_plan(B, H, F, feat, aux_d, n_out, int8_hh,
                                    int8_ff, max_clusters, K, limit, b,
                                    int8_gates)
            except ValueError as e:
                if "do not fit" not in str(e):
                    raise
        budget = DOT_BUDGETS[-1]
    if B < 1 or max_clusters < 1:
        raise ValueError(f"B and max_clusters must be >= 1, got {B}, "
                         f"{max_clusters}")
    if H % 16 or F % (16 if int8_ff else 8):
        raise ValueError(f"the cluster kernel takes H a multiple of 16 and "
                         f"F of {16 if int8_ff else 8}, got H={H}, F={F}")
    K = cluster_size(H, F, int8_ff) if K is None else K
    gF = 16 if int8_ff else 8
    nGH, nGF = H // 16, F // gF
    if K < 1 or K > CLUSTER_KMAX or K & (K - 1) or K > min(nGH, nGF):
        raise ValueError(f"cluster size {K} is not a power of two up to "
                         f"{min(nGH, nGF, CLUSTER_KMAX)} for H={H}, F={F}")
    need = -(-B // max_clusters)
    rc = 1 if need == 1 else 2
    rows = -(-need // rc) * rc
    clusters = -(-B // rows)
    U = 16 * -(-nGH // K)
    Fo = gF * -(-nGF // K)
    d, K0 = aux_d, feat + aux_d
    C = feat + 4 * aux_d
    nrc = rows // rc
    Kd = dict(im1=K0, im=K0, hh1=H, ih2=H, aux2=d, hh2=H, fc1=H, aux3=d,
              fc2=F, aux4=d, fc3=Fo)
    ng = dict(im1=3, im=1, hh1=3, ih2=3, aux2=3, hh2=3, fc1=1, aux3=1,
              fc2=1, aux4=1, fc3=1)
    np_ = dict(im1=U, im=U, hh1=U, ih2=U, aux2=U, hh2=U, fc1=Fo, aux3=Fo,
               fc2=Fo, aux4=Fo, fc3=n_out)
    is8 = dict.fromkeys(CLUSTER_DOTS, False)
    is8.update(hh1=int8_hh, hh2=int8_hh, ih2=int8_ff, fc1=int8_ff,
               fc2=int8_ff)
    # a bf16 dot's partial sums live only until its window or epilogue adds
    # them up: every window's dots and every phase's dot share one region;
    # an int8 dot's atomic sums have their own
    splits, offsets, ints, pre = {}, {}, {}, 0
    group = dict.fromkeys(range(5), 0)
    for name in CLUSTER_DOTS:
        V = 1 if name == "fc3" else 16 if is8[name] else 8
        min_rows = 16 if is8[name] else 8
        cols = ng[name] * np_[name]
        smax = Kd[name] if is8[name] else max(1, budget // (cols * rows * 8))
        S, L = dot_split(Kd[name], nrc * (cols // V), CLUSTER_THREADS,
                         4 if is8[name] else 1, smax, min_rows)
        splits[name] = (S, L)
        if is8[name]:
            ints[name] = _align16((cols + cols // 16) * rows * 4)
            continue
        n = _align16(S * cols * rows * 8)
        w = CLUSTER_WINDOW[name]
        offsets[name] = group[w] if w else 0
        group[w] = group[w] + n if w else max(group[0], n)
        if w:
            pre += _align16(cols * rows * 4)
    used = max(group.values())
    for name, n in ints.items():
        offsets[name] = used
        used += n
    regions = {"partial sums": max(group.values()),
               "int8 sums": sum(ints.values()), "added-up sums": pre}
    used += pre
    W = max(H, F)
    hbytes = _align16(H * rows * (4 if int8_gates else 1 if int8_hh else 8))
    ab = _align16(W * rows * (4 if int8_gates else 1 if int8_ff else 8))
    for name, n in (("cond", _align16(C * rows * 8)),
                    ("cond rows", 2 * _align16(C * rows * 2)),
                    ("h1", 2 * hbytes),
                    ("h2", hbytes), ("a", ab), ("b", ab),
                    ("own f2", _align16(Fo * rows * 8)),
                    ("fc3 partials", K * _align16(n_out * rows * 8)),
                    ("own", 3 * _align16(U * rows * 4)),
                    ("logits", _align16(rows * n_out * 4)),
                    ("xs", _align16(rows * 4)),
                    ("constants", _align16(
                        ((13 + 6 * int8_hh + 3 * int8_ff) * U
                         + (4 if int8_ff else 2) * Fo + n_out) * 4))):
        regions[name] = n
        used += n
    if int8_gates:
        for name, n in (("int8 plane", _align16(W * rows)),
                        ("maxima", _align16(5 * rows * K * 4)),
                        ("row scales", _align16(5 * rows * 4))):
            regions[name] = n
            used += n
    if used > limit:
        raise ValueError(
            f"{B} fold rows do not fit the cluster kernel on clusters of {K} "
            f"CTAs ({max_clusters} co-resident): {rows} rows a cluster need "
            f"{used} bytes of shared memory per CTA, the limit is {limit}")
    return dict(K=K, rows=rows, rc=rc, clusters=clusters, U=U, Fo=Fo,
                budget=budget,
                units=[owned(nGH, 16, q, K) for q in range(K)],
                fc=[owned(nGF, gF, q, K) for q in range(K)],
                splits=splits, offsets=offsets, regions=regions, bytes=used)


def pick_cluster_plan(B: int, H: int, F: int, feat: int, aux_d: int,
                      n_out: int, int8_hh: bool, int8_ff: bool,
                      clusters_at, int8_gates: bool = False) -> dict:
    """The plan on the widest cluster whose layout fits in the fewest
    waves: K from :func:`cluster_size` down to 1, ``clusters_at(K)`` the
    co-resident clusters of K CTAs (0: the card takes none).  One wave
    where any K fits; past that (rows no layout holds, e.g. a co-batch of
    many long utterances) the clusters run in ``waves`` waves, each
    repeating the T steps.  Raises ``ValueError`` naming every K tried
    when not even one row a cluster fits.  ``int8_gates`` as in
    :func:`cluster_plan`."""
    tried = []
    waves, most = 1, 1
    while True:
        K = cluster_size(H, F, int8_ff or int8_gates)
        while K >= 1:
            n = clusters_at(K)
            most = max(most, n)
            if n >= 1:
                try:
                    plan = cluster_plan(B, H, F, feat, aux_d, n_out, int8_hh,
                                        int8_ff, n * waves, K,
                                        int8_gates=int8_gates)
                    plan["waves"] = -(-plan["clusters"] // n)
                    return plan
                except ValueError as e:
                    if waves == 1:
                        tried.append(str(e))
            elif waves == 1:
                tried.append(f"no cluster of {K} CTAs fits the card")
            K //= 2
        if waves * most >= B:
            raise ValueError("no cluster plan fits: " + "; ".join(tried))
        waves += 1


_MAX_CLUSTERS: dict = {}


def max_clusters(lib, device: torch.device, K: int, int8_hh: bool,
                 int8_ff: bool, int8_gates: bool = False) -> int:
    """The card's co-resident clusters of ``K`` CTAs, one CTA an SM
    (``wavernn_decode_cluster_max``), asked once per device and variant
    (``int8_gates`` implies ``int8_hh`` and ``int8_ff``)."""
    int8_hh, int8_ff = int8_hh or int8_gates, int8_ff or int8_gates
    key = (device.index, K, bool(int8_hh), bool(int8_ff), bool(int8_gates))
    if key not in _MAX_CLUSTERS:
        out = ctypes.c_int(0)
        dims = (ctypes.c_longlong * 4)(K, int(int8_hh), int(int8_ff),
                                       int(int8_gates))
        with torch.cuda.device(device):
            err = lib.wavernn_decode_cluster_max(ctypes.byref(out), dims)
        if err != 0:
            raise RuntimeError(
                f"cudaOccupancyMaxActiveClusters for clusters of {K}: "
                f"{lib.wavernn_error_string(err).decode()}")
        _MAX_CLUSTERS[key] = out.value
    return _MAX_CLUSTERS[key]


# -- the kernel's wrapper -------------------------------------------------

def _check_cuda(packed: dict, cond: torch.Tensor, T: int, mode: str,
                n_classes: int, ablate, mask: int, rows_per_cta: int):
    """The checks of a launch on the card; returns (B, Tc, C, H, F, d, K0,
    n_out, int8_hh, int8_ff)."""
    int8_gates = is_int8_gates(packed)
    _check(packed, cond, T, mode)
    B, Tc, C = cond.shape
    H = packed["b_hh1_n"].shape[0]
    F = packed["b_fc1"].shape[0]
    d = packed["w_aux"].shape[0] // 3
    K0 = packed["w_Im"].shape[0]
    n_out = packed["b_fc3"].shape[0]
    int8_hh = is_int8_hh(packed)
    int8_ff = is_int8_ff(packed)
    if n_out != n_classes:
        raise ValueError(f"fc3 has {n_out} outputs, n_classes={n_classes}")
    if mask and (frozenset(ablate) not in KERNEL_ABLATIONS or not int8_hh
                 or int8_ff or rows_per_cta != ROWS_PER_CTA):
        raise ValueError(
            f"the kernel is built with the ablations "
            f"{[sorted(a) for a in KERNEL_ABLATIONS[1:]]} for int8_hh, bf16 "
            f"feed-forward matrices and {ROWS_PER_CTA} row(s) per CTA; got "
            f"{sorted(ablate)}, int8_hh={int8_hh}, int8_ff={int8_ff}, "
            f"rows_per_cta={rows_per_cta}")
    if mode == "MOL" and (n_out % 3 or n_out // 3 > 32):
        raise ValueError(f"MOL kernel takes 3*nm outputs with nm <= 32, "
                         f"got {n_out}")
    i8_ff = int8_ff or int8_gates
    if H % 16 or F % (16 if i8_ff else 8):
        raise ValueError(f"the kernel's 16-byte weight loads take H a "
                         f"multiple of 16 and F of 8 (16 with int8 "
                         f"feed-forward matrices), got H={H}, F={F}, "
                         f"variant {variant(packed)}")
    if not cond.is_contiguous():
        raise ValueError("cond must be contiguous")
    ff_dtype = torch.int8 if i8_ff else torch.bfloat16
    hh_dtype = torch.int8 if int8_hh or int8_gates else torch.bfloat16
    shapes = dict(
        w_Im1=((K0, 3 * H), torch.bfloat16), u1=((3 * H,), torch.float32),
        w_Im=((K0, H), torch.bfloat16), w_x=((H,), torch.float32),
        b_I=((H,), torch.float32),
        w_hh1=((H, 3 * H), hh_dtype),
        b1=((3 * H,), torch.float32), b_hh1_n=((H,), torch.float32),
        w_ih2x=((H, 3 * H), ff_dtype),
        w_hh2=((H, 3 * H), hh_dtype),
        b2=((3 * H,), torch.float32), b_hh2_n=((H,), torch.float32),
        w_fc1x=((H, F), ff_dtype), b_fc1=((F,), torch.float32),
        w_fc2x=((F, F), ff_dtype), b_fc2=((F,), torch.float32),
        w_aux=((3 * d, 3 * H + 2 * F), torch.bfloat16),
        w_fc3=((F, n_out), torch.bfloat16), b_fc3=((n_out,), torch.float32),
    )
    if int8_hh or int8_gates:
        shapes.update(w_hh1_s=((3 * H,), torch.float32),
                      w_hh2_s=((3 * H,), torch.float32))
    if int8_gates:
        shapes.update(w_ih2x_s=((3 * H,), torch.float32),
                      w_fc1x_s=((F,), torch.float32),
                      w_fc2x_s=((F,), torch.float32))
    if int8_ff:
        shapes.update(w_ih2x_fs=((3 * H,), torch.float32),
                      w_fc1x_fs=((F,), torch.float32),
                      w_fc2x_fs=((F,), torch.float32),
                      ffq=((3,), torch.float32))
    for name, (shape, dtype) in shapes.items():
        t = packed.get(name)
        if t is None:
            raise ValueError(f"packed[{name!r}] is missing")
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != cond.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"packed[{name!r}]: want {shape} {dtype} contiguous and "
                f"16-byte aligned on {cond.device}, got {tuple(t.shape)} "
                f"{t.dtype} {t.device} at {t.data_ptr():#x}")

    return B, Tc, C, H, F, d, K0, n_out, int8_hh, int8_ff


def _pointers(packed: dict, cond: torch.Tensor, out: torch.Tensor) -> list:
    return [cond.data_ptr(), out.data_ptr()] + [
        packed[k].data_ptr() if packed.get(k) is not None else 0
        for k in WEIGHT_ORDER]


def _cluster_dims(lib, shape, cond, T, seed, mode, deterministic,
                  row0, int8_gates: bool = False) -> list:
    """The cluster kernel's dims: the plan for the card's co-resident
    clusters, checked against the kernel's own layout."""
    B, Tc, C, H, F, d, K0, n_out, int8_hh, int8_ff = shape
    int8_hh, int8_ff = int8_hh or int8_gates, int8_ff or int8_gates
    plan = pick_cluster_plan(
        B, H, F, K0 - d, d, n_out, int8_hh, int8_ff,
        lambda k: max_clusters(lib, cond.device, k, int8_hh, int8_ff,
                               int8_gates), int8_gates)
    layout = [H, F, K0 - d, d, n_out, int(int8_hh), int(int8_ff), plan["K"],
              plan["rows"], plan["rc"], plan["budget"], int(int8_gates)]
    nb = lib.wavernn_decode_cluster_bytes(
        (ctypes.c_longlong * len(layout))(*layout))
    if nb != plan["bytes"]:
        raise RuntimeError(f"decode cluster kernel: its layout takes {nb} "
                           f"bytes, the plan {plan['bytes']}")
    return [B, Tc, C, T, H, F, K0 - d, d, n_out, _MODES[mode],
            int(deterministic), int(int8_hh), int(int8_ff), seed & 0xFFFFFFFF,
            row0, plan["K"], plan["rows"], plan["rc"], plan["clusters"],
            plan["budget"], plan["bytes"], int(int8_gates)]


def _call(lib, entry, design: str, ptrs: list, dims: list, device,
          *extra) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = entry((ctypes.c_void_p * len(ptrs))(*ptrs),
                    (ctypes.c_longlong * len(dims))(*dims),
                    ctypes.c_void_p(stream), *extra)
    if err != 0:
        raise RuntimeError(f"decode kernel ({design} design) launch failed: "
                           f"{lib.wavernn_error_string(err).decode()}")


def design_for(packed: dict, ablate: frozenset = frozenset(),
               design: str | None = None) -> str:
    """The kernel design a launch of ``packed`` takes: ``design``, by
    default ``"cluster"`` for every variant (``int8_gates`` too) and
    ``"row"`` for an ablation.  Raises for an unknown design and for an
    ablation asked of the cluster design."""
    mask = ablation_mask(ablate)
    if design is None:
        design = "row" if mask else "cluster"
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    if design == "cluster" and mask:
        raise ValueError(
            f"the cluster design takes no ablation (they run on "
            f"design='row'); got variant {variant(packed)}, "
            f"ablate={sorted(ablate)}")
    return design


def decode(packed: dict, cond: torch.Tensor, T: int, seed: int, mode: str,
           n_classes: int, deterministic: bool,
           ablate: frozenset = frozenset(),
           rows_per_cta: int = ROWS_PER_CTA, row0: int = 0,
           design: str | None = None) -> torch.Tensor:
    """(B, T) float32 samples of the sample loop over fold-major bf16
    conditioning ``cond`` (B, >=T, C).  The kernel variant is the pack's
    (:func:`variant`): int8 recurrent matrices, int8 feed-forward matrices
    (with their ``ffq``), or ``int8_gates``.  ``design`` picks the kernel
    (the module's docstring): ``"cluster"``, the default for every variant
    (``int8_gates`` too); the ablations take ``"row"`` and raise when asked
    for ``"cluster"``, on the CPU too.  ``rows_per_cta`` (1 or
    2) is the row design's fold rows per CTA (the cluster design plans its
    own and raises on another value); ``row0`` is the random bits' row of
    row 0 (a shard's offset in its batch); ``ablate`` as in the module's
    docstring (the row kernel is built with the ablations in
    :data:`KERNEL_ABLATIONS`, for int8 recurrent matrices and
    :data:`ROWS_PER_CTA` rows per CTA).  The kernels' 16-byte weight loads
    take H a multiple of 16 and F of 8 (of 16 with int8 feed-forward
    matrices), and 16-byte aligned weights; other shapes raise.
    ``int8_gates`` takes no ablation and, on the row design,
    :data:`ROWS_PER_CTA` rows per CTA; other settings raise, on the CPU
    too.

    A CUDA tensor launches the design's kernel (``csrc/decode_cluster.cu``
    or ``csrc/decode.cu``) on the current stream, or raises (a cluster
    launch the card refuses raises with its error; nothing falls back); a
    CPU tensor runs :func:`decode_reference`.  ``decode.launches`` counts
    kernel launches, ``decode.launches_cluster`` those of the cluster
    design, ``decode.launches_int8_ff`` those with int8 feed-forward
    matrices, ``decode.launches_int8_gates`` those of ``int8_gates``."""
    mask = ablation_mask(ablate)
    if rows_per_cta not in (1, 2):
        raise ValueError(f"rows_per_cta must be 1 or 2, got {rows_per_cta}")
    if not 0 <= row0 < 2 ** 32:
        raise ValueError(f"row0 must be in [0, 2**32), got {row0}")
    int8_gates = is_int8_gates(packed)
    if int8_gates and (mask or rows_per_cta != ROWS_PER_CTA):
        raise ValueError(
            f"the int8_gates kernel is built for {ROWS_PER_CTA} row(s) per "
            f"CTA and no ablation; got rows_per_cta={rows_per_cta}, "
            f"ablate={sorted(ablate)}")
    design = design_for(packed, ablate, design)
    if design == "cluster" and rows_per_cta != ROWS_PER_CTA:
        raise ValueError(f"rows_per_cta={rows_per_cta} is the row design's; "
                         f"the cluster design plans its rows itself")
    if cond.device.type == "cpu":
        return decode_reference(packed, cond, T, seed, mode, n_classes,
                                deterministic, ablate, row0)
    if cond.device.type != "cuda":
        raise ValueError(f"decode runs on CUDA or CPU tensors, got "
                         f"{cond.device}")
    shape = _check_cuda(packed, cond, T, mode, n_classes, ablate, mask,
                        rows_per_cta)

    from wavernn_tpu_torch.ops.build import load_library

    lib = load_library()
    out = torch.empty(cond.shape[0], T, dtype=torch.float32,
                      device=cond.device)
    if design == "cluster":
        dims = _cluster_dims(lib, shape, cond, T, seed, mode, deterministic,
                             row0, int8_gates)
        entry = lib.wavernn_decode_cluster
    else:
        B, Tc, C, H, F, d, K0, n_out, int8_hh, int8_ff = shape
        dims = [B, Tc, C, T, H, F, K0 - d, d, n_out, _MODES[mode],
                int(deterministic), int(int8_hh), rows_per_cta,
                seed & 0xFFFFFFFF, mask, int(int8_ff), row0, int(int8_gates)]
        entry = lib.wavernn_decode
    _call(lib, entry, design, _pointers(packed, cond, out), dims, cond.device)
    decode.launches += 1
    decode.launches_cluster += int(design == "cluster")
    decode.launches_int8_ff += int(shape[-1])
    decode.launches_int8_gates += int(int8_gates)
    return out


decode.launches = 0
decode.launches_cluster = 0
decode.launches_int8_ff = 0
decode.launches_int8_gates = 0

# stamps a step of decode_cluster_spans (NSPAN in csrc/decode_cluster.cu):
# each is the time at which CTA 0 of the first cluster passed that point
CLUSTER_SPANS = ("start", "gru1", "window1+barrier1", "ih2_dot", "gru2",
                 "window2+barrier2", "fc1", "window3+barrier3", "fc2",
                 "fc3_partial", "window4", "barrier4")


def decode_cluster_spans(packed: dict, cond: torch.Tensor, T: int, seed: int,
                         mode: str, n_classes: int, deterministic: bool):
    """Dev only: the cluster kernel's int8_hh + int8_ff (or int8_gates)
    instantiation that stamps the card's nanosecond clock
    (``%globaltimer``) at the points of :data:`CLUSTER_SPANS` in every
    step.  Returns (:func:`decode`'s
    samples, the stamps (T, len(CLUSTER_SPANS)) int64 on the card).  Not
    counted in ``decode.launches``; nothing on the request path calls it."""
    if cond.device.type != "cuda":
        raise ValueError(f"the spans launch needs CUDA tensors, got "
                         f"{cond.device}")
    if variant(packed) not in ("int8_hh+int8_ff", "int8_gates"):
        raise ValueError(f"the spans launch is built for int8_hh+int8_ff "
                         f"and int8_gates, got {variant(packed)}")
    shape = _check_cuda(packed, cond, T, mode, n_classes, frozenset(), 0,
                        ROWS_PER_CTA)
    from wavernn_tpu_torch.ops.build import load_library

    lib = load_library()
    out = torch.empty(cond.shape[0], T, dtype=torch.float32,
                      device=cond.device)
    spans = torch.zeros(T, len(CLUSTER_SPANS), dtype=torch.int64,
                        device=cond.device)
    dims = _cluster_dims(lib, shape, cond, T, seed, mode, deterministic, 0,
                         is_int8_gates(packed))
    _call(lib, lib.wavernn_decode_cluster_spans, "cluster spans",
          _pointers(packed, cond, out), dims, cond.device,
          ctypes.c_void_p(spans.data_ptr()))
    return out, spans
