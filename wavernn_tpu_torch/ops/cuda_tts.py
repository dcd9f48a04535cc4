"""The Tacotron decoder step loop as one hand-written CUDA kernel for
Hopper (``csrc/tts_decode.cu``; replaces
``wavernn_tpu/ops/pallas_tts.py::_tts_decode_kernel``).

:func:`tts_decode` launches the kernel for CUDA tensors and runs its plain
PyTorch version (``tts_decode.tts_decode_reference``) for CPU tensors; it
never falls back from one to the other.  ``tts_decode.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from wavernn_tpu_torch.ops.tts_decode import (
    MATRICES, STATE_FIELDS, TTSDecodeState, check_inputs, packed_dims,
    tts_decode_reference,
)

# pointer order of the C entry point, before enc_t, encp and the buffers
WEIGHT_ORDER = (
    "p1_w", "p1_b", "p2_w", "p2_b",
    "wih_c", "wih_p", "whh", "b_attn", "b_attn_hn",
    "M_loc", "W_q", "b_q", "v",
    "ri_c", "ri_h", "ri_b",
    "l1_ih", "l1_hh", "l1_b", "l2_ih", "l2_hh", "l2_b",
    "mel_w",
)
# CTAs of the cooperative grid (one per SM), capped by what fits.  Measured
# on an H100 (700 W), full width, L=64: 72.9 / 55.1 / 48.3 / 48.5 / 49.1 us
# per step at 16 / 32 / 64 / 96 / 128 CTAs (PERF.md).
CTAS = 64


def _shapes(D: int, Dh: int, H: int, n_mels: int, r: int) -> dict:
    return dict(
        p1_w=(D, n_mels), p1_b=(D,), p2_w=(Dh, D), p2_b=(Dh,),
        wih_c=(3 * D, D), wih_p=(3 * D, Dh), whh=(3 * D, D),
        b_attn=(3 * D,), b_attn_hn=(D,),
        M_loc=(D, 62), W_q=(D, D), b_q=(D,), v=(1, D),
        ri_c=(H, D), ri_h=(H, D), ri_b=(H,),
        l1_ih=(4 * H, H), l1_hh=(4 * H, H), l1_b=(4 * H,),
        l2_ih=(4 * H, H), l2_hh=(4 * H, H), l2_b=(4 * H,),
        mel_w=(r * n_mels, H),
    )


def _check_cuda(packed: dict, enc: torch.Tensor, encp: torch.Tensor,
                state: TTSDecodeState, n_steps: int):
    D, Dh, H, n_mels, r, L = check_inputs(packed, enc, encp, state, n_steps)
    for name, n in (("D", D), ("D/2", Dh), ("H", H), ("n_mels", n_mels)):
        if n % 8:
            raise ValueError(f"the kernel takes widths that are multiples "
                             f"of 8, got {name}={n}")
    dev = enc.device
    for name, shape in _shapes(D, Dh, H, n_mels, r).items():
        t = packed[name]
        dtype = torch.bfloat16 if name in MATRICES else torch.float32
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"packed[{name!r}]: want {shape} {dtype} contiguous on {dev}, "
                f"got {tuple(t.shape)} {t.dtype} {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)"))
    for name, t in (("enc", enc), ("encp", encp)):
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be float32 contiguous on {dev}, "
                             f"got {t.dtype} {t.device}")
    for name in STATE_FIELDS:
        if getattr(state, name).device != dev:
            raise ValueError(f"state.{name} is not on {dev}")
    return D, Dh, H, n_mels, r, L


def tts_decode(packed: dict, enc: torch.Tensor, encp: torch.Tensor,
               state: TTSDecodeState, n_steps: int, int8_lstm: bool = False):
    """``n_steps`` decoder steps from ``state`` over the encoder outputs
    ``enc``/``encp`` (L, D) float32.  Returns (mels (n_steps, r, n_mels),
    scores (n_steps, L), stop_max (n_steps,), new state).

    CUDA tensors launch the kernel on the current stream (bf16 packing
    only); CPU tensors run :func:`tts_decode_reference`."""
    if int8_lstm:
        raise NotImplementedError("int8_lstm is not ported")
    if enc.device.type == "cpu":
        return tts_decode_reference(packed, enc, encp, state, n_steps)
    if enc.device.type != "cuda":
        raise ValueError(f"tts_decode runs on CUDA or CPU tensors, got "
                         f"{enc.device}")
    D, Dh, H, n_mels, r, L = _check_cuda(packed, enc, encp, state, n_steps)

    from wavernn_tpu_torch.ops.build import load_library

    lib = load_library()
    dev = enc.device
    with torch.cuda.device(dev):
        fit = ctypes.c_int(0)
        err = lib.tts_decode_max_ctas(ctypes.byref(fit), L, D, Dh, H, n_mels)
        if err != 0:
            raise RuntimeError(
                f"tts_decode kernel: no launch fits a text of {L} symbols: "
                f"{lib.wavernn_error_string(err).decode()}")
        grid = min(CTAS, fit.value)
        if grid < 1:
            raise RuntimeError(f"tts_decode kernel: no CTA fits at L={L}")
        f32 = dict(dtype=torch.float32, device=dev)
        enc_t = enc.t().contiguous()
        state_in = torch.cat([getattr(state, f) for f in STATE_FIELDS])
        state_out = torch.empty_like(state_in)
        mels = torch.empty(n_steps, r * n_mels, **f32)
        scores = torch.empty(n_steps, L, **f32)
        stop = torch.empty(n_steps, **f32)
        work = torch.empty(n_mels + Dh + 5 * D + L + 11 * H, **f32)
        bar = torch.zeros(2, dtype=torch.int32, device=dev)
        ptrs = [packed[k].data_ptr() for k in WEIGHT_ORDER] + [
            t.data_ptr() for t in (enc_t, encp, state_in, state_out, mels,
                                   scores, stop, work, bar)]
        dims = [n_steps, L, D, Dh, H, n_mels, r, grid]
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tts_decode(
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(dims))(*dims),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"tts_decode kernel launch failed: "
                           f"{lib.wavernn_error_string(err).decode()}")
    tts_decode.launches += 1
    sizes = [getattr(state, f).shape[0] for f in STATE_FIELDS]
    new_state = TTSDecodeState(*torch.split(state_out, sizes))
    return mels.view(n_steps, r, n_mels), scores, stop, new_state


tts_decode.launches = 0
