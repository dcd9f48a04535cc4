"""The WaveRNN sample loop as one hand-written CUDA kernel for Hopper.

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
# Fold rows per CTA (the ablations are built for this one: ABLATION_R in
# csrc/decode.cu).  Measured on an H100 (700 W) at 64 rows x 2,048 steps
# with int8_hh: 72.94 us/step at 1 (1,024 threads), more than twice that
# at 2 (512 threads; PERF.md): a CTA builds each weight's double once for
# its R rows, but its float64 FMAs grow with R and it has half the
# threads.  Up to 132 rows (one CTA per SM) one row per CTA is faster.
ROWS_PER_CTA = 1
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


# -- the kernel's wrapper -------------------------------------------------

def decode(packed: dict, cond: torch.Tensor, T: int, seed: int, mode: str,
           n_classes: int, deterministic: bool,
           ablate: frozenset = frozenset(),
           rows_per_cta: int = ROWS_PER_CTA, row0: int = 0) -> torch.Tensor:
    """(B, T) float32 samples of the sample loop over fold-major bf16
    conditioning ``cond`` (B, >=T, C).  The kernel variant is the pack's
    (:func:`variant`): int8 recurrent matrices, int8 feed-forward matrices
    (with their ``ffq``), or ``int8_gates``.  ``rows_per_cta`` (1 or 2) is the
    kernel's fold rows per CTA; ``row0`` is the random bits' row of row 0
    (a shard's offset in its batch); ``ablate`` as in the module's
    docstring (the kernel
    is built with the ablations in :data:`KERNEL_ABLATIONS`, for int8
    recurrent matrices and :data:`ROWS_PER_CTA` rows per CTA).  The
    kernel's 16-byte weight loads take H a multiple of 16 and F of 8 (of 16
    with int8 feed-forward matrices), and 16-byte aligned weights; other
    shapes raise.  ``int8_gates`` is built for :data:`ROWS_PER_CTA` rows
    per CTA and no ablation; other settings raise, on the CPU too.

    A CUDA tensor launches the kernel (``csrc/decode.cu``) on the current
    stream; a CPU tensor runs :func:`decode_reference`.  ``decode.launches``
    counts kernel launches, ``decode.launches_int8_ff`` those with int8
    feed-forward matrices, ``decode.launches_int8_gates`` those of
    ``int8_gates``."""
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
    if cond.device.type == "cpu":
        return decode_reference(packed, cond, T, seed, mode, n_classes,
                                deterministic, ablate, row0)
    if cond.device.type != "cuda":
        raise ValueError(f"decode runs on CUDA or CPU tensors, got "
                         f"{cond.device}")
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

    from wavernn_tpu_torch.ops.build import load_library

    lib = load_library()
    out = torch.empty(B, T, dtype=torch.float32, device=cond.device)
    ptrs = [cond.data_ptr(), out.data_ptr()] + [
        packed[k].data_ptr() if packed.get(k) is not None else 0
        for k in WEIGHT_ORDER]
    dims = [B, Tc, C, T, H, F, K0 - d, d, n_out, _MODES[mode],
            int(deterministic), int(int8_hh), rows_per_cta, seed & 0xFFFFFFFF,
            mask, int(int8_ff), row0, int(int8_gates)]
    stream = torch.cuda.current_stream(cond.device).cuda_stream
    with torch.cuda.device(cond.device):
        err = lib.wavernn_decode(
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(dims))(*dims),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: "
                           f"{lib.wavernn_error_string(err).decode()}")
    decode.launches += 1
    decode.launches_int8_ff += int(int8_ff)
    decode.launches_int8_gates += int(int8_gates)
    return out


decode.launches = 0
decode.launches_int8_ff = 0
decode.launches_int8_gates = 0
