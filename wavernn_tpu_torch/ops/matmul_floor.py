"""The decode step's matmul floor as a hand-written CUDA kernel for Hopper.

Counterpart of ``tools/kernel_breakdown.py::matmul_only_kernel``: T serial
steps of six bf16 dots of a (B, H) state, then tanh of the sum of six of
their column blocks,

    hb = bf16(h)
    h  = tanh(g1[:, :H] + g2[:, H:2H] + g3[:, 2H:] + g4[:, :H] + f1 + f2)
    g_m = hb @ w_m  (H, 3H),  f_m = hb @ wf_m  (H, H)

where each dot sums its exact bf16 products in float64 and rounds the sum
once to float32.  The 8 * H columns the formula discards are summed per
row over all steps in float64 (``sink``; ``sink_abs`` sums their absolute
values), so the kernel must compute every product.

The JAX kernel starts from h = 0, and tanh(0 @ W) = 0: its output is zero
for any weights.  ``h0`` gives a nonzero start, so that a comparison of the
kernel with :func:`matmul_floor_reference` tests something.

:func:`matmul_floor` launches ``csrc/matmul_floor.cu`` for CUDA tensors and
runs :func:`matmul_floor_reference` for CPU tensors; ``matmul_floor.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

H_FLOOR = 512
WEIGHT_ORDER = ("w1", "w2", "w3", "w4", "wf1", "wf2")


def make_floor_weights(seed: int = 0, H: int = H_FLOOR,
                       device="cpu") -> dict:
    """The floor's six bf16 matrices: standard normals from
    ``np.random.default_rng(seed)`` times 0.05, (H, 3H) for w1..w4 and
    (H, H) for wf1, wf2."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in WEIGHT_ORDER:
        shape = (H, H) if name.startswith("wf") else (H, 3 * H)
        a = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        out[name] = torch.from_numpy(a).to(torch.bfloat16).to(device)
    return out


def floor_macs(B: int, T: int, H: int = H_FLOOR) -> int:
    """Multiply-adds of one call: every step computes all 4 * 3H + 2 * H
    columns for every row."""
    return B * T * H * (4 * 3 * H + 2 * H)


def _check(weights: dict, B: int, T: int, h0: Optional[torch.Tensor]) -> int:
    if B < 1 or T < 1:
        raise ValueError(f"B and T must be positive, got B={B}, T={T}")
    H = weights["wf1"].shape[0]
    dev = weights["wf1"].device
    for name in WEIGHT_ORDER:
        t = weights[name]
        shape = (H, H) if name.startswith("wf") else (H, 3 * H)
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"weights[{name!r}]: want {shape} bfloat16 contiguous on "
                f"{dev}, got {tuple(t.shape)} {t.dtype} {t.device}")
    if h0 is not None and (tuple(h0.shape) != (B, H)
                           or h0.dtype != torch.float32 or h0.device != dev
                           or not h0.is_contiguous()):
        raise ValueError(f"h0: want ({B}, {H}) float32 contiguous on {dev}, "
                         f"got {tuple(h0.shape)} {h0.dtype} {h0.device}")
    return H


def matmul_floor_reference(weights: dict, B: int, T: int,
                           h0: Optional[torch.Tensor] = None):
    """Plain PyTorch version: ``(h (B, H) f32, sink (B,) f64, sink_abs (B,)
    f64)``.  Each dot takes the bf16-rounded state, sums the exact bf16
    products in float64 and rounds once to float32; the five float32
    additions follow the JAX kernel's order."""
    H = _check(weights, B, T, h0)
    dev = weights["wf1"].device
    w64 = {k: weights[k].double() for k in WEIGHT_ORDER}
    h = (torch.zeros(B, H, device=dev) if h0 is None else h0.clone())
    sink = torch.zeros(B, dtype=torch.float64, device=dev)
    sink_abs = torch.zeros(B, dtype=torch.float64, device=dev)
    for _ in range(T):
        hb = h.to(torch.bfloat16).double()
        g1, g2, g3, g4, f1, f2 = ((hb @ w64[k]).float() for k in WEIGHT_ORDER)
        h = torch.tanh(g1[:, :H] + g2[:, H:2 * H] + g3[:, 2 * H:]
                       + g4[:, :H] + f1 + f2)
        dropped = torch.cat([g1[:, H:], g2[:, :H], g2[:, 2 * H:],
                             g3[:, :2 * H], g4[:, H:]], dim=1).double()
        sink += dropped.sum(dim=1)
        sink_abs += dropped.abs().sum(dim=1)
    return h, sink, sink_abs


def matmul_floor(weights: dict, B: int, T: int,
                 h0: Optional[torch.Tensor] = None):
    """``(h (B, H) f32, sink (B,) f64, sink_abs (B,) f64)`` after T steps
    from ``h0`` (zeros when None, as the JAX kernel starts).  CUDA weights
    launch the kernel on the current stream; CPU weights run
    :func:`matmul_floor_reference`."""
    H = _check(weights, B, T, h0)
    dev = weights["wf1"].device
    if dev.type == "cpu":
        return matmul_floor_reference(weights, B, T, h0)
    if dev.type != "cuda":
        raise ValueError(f"matmul_floor runs on CUDA or CPU tensors, got {dev}")
    misaligned = [k for k in WEIGHT_ORDER if weights[k].data_ptr() % 16]
    if H % 8 or misaligned:
        raise ValueError(f"the kernel's 16-byte weight loads take H a "
                         f"multiple of 8 and 16-byte aligned weights, got "
                         f"H={H}, misaligned {misaligned}")

    from wavernn_tpu_torch.ops.build import load_library

    lib = load_library()
    if h0 is None:
        h0 = torch.zeros(B, H, device=dev)
    h = torch.empty(B, H, device=dev)
    sink = torch.empty(B, dtype=torch.float64, device=dev)
    sink_abs = torch.empty(B, dtype=torch.float64, device=dev)
    ptrs = [h0.data_ptr(), h.data_ptr(), sink.data_ptr(),
            sink_abs.data_ptr()] + [weights[k].data_ptr() for k in WEIGHT_ORDER]
    dims = [B, T, H]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.matmul_floor((ctypes.c_void_p * len(ptrs))(*ptrs),
                               (ctypes.c_longlong * len(dims))(*dims),
                               ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"matmul floor kernel launch failed: "
                           f"{lib.wavernn_error_string(err).decode()}")
    matmul_floor.launches += 1
    return h, sink, sink_abs


matmul_floor.launches = 0
