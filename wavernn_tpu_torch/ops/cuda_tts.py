"""The Tacotron decoder step loop as one hand-written CUDA kernel for
Hopper (``csrc/tts_decode.cu``; replaces
``wavernn_tpu/ops/pallas_tts.py::_tts_decode_kernel``).

:func:`tts_decode` launches the kernel for CUDA tensors and runs its plain
PyTorch version (``tts_decode.tts_decode_reference``) for CPU tensors; it
never falls back from one to the other.  The kernel's variant is the
packed set's: bf16, or ``int8_lstm`` (int8 LSTM rows).
``tts_decode.launches`` counts kernel launches,
``tts_decode.launches_int8_lstm`` those of ``int8_lstm`` and
``tts_decode.launches_global`` those in the global placement.
:func:`tts_smem_plan` is the kernel's memory plan: which output units,
text positions and context columns each CTA owns, the shared bytes every
CTA allocates and, for a text too long for shared memory, the global
workspace its L-sized state moves to (the plan's ``placement``);
:func:`shared_text_limit` is the longest text the shared placement holds.
Past it the global placement keeps only each CTA's conv window of
cumulative and previous attention in shared memory, 24 bytes a position
it owns: a text raises only once that window no longer fits beside the
fixed part (past ~580,000 symbols at full width on 132 CTAs, sooner on
fewer), and a grid whose fixed part alone does not fit raises for any
text.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wavernn_tpu_torch.ops.tts_decode import (
    LSTM_MATRICES, LSTM_SCALES, MATRICES, STATE_FIELDS, TTSDecodeState,
    check_inputs, is_int8_lstm, tts_decode_reference,
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
# CTAs of the cooperative grid: None is one per SM of the card (132 on an
# H100), each holding its units' weights in shared memory for the launch;
# an int pins the grid (the card tests set it to leave CTAs without units).
# Every SM is used: a CTA's share of the weights shrinks with the grid while
# the hand-over between CTAs barely grows (a bare grid barrier: 0.94 / 1.02
# us at 64 / 132 CTAs on an H100, PERF.md).
CTAS = None

SMEM_LIMIT = 232_448   # shared memory one CTA may use on Hopper (227 KB)
NW = 8                 # warps of a CTA (256 threads)
MAXG = 6               # the most sums of one unit (the attention GRU's)
NTAP2 = 62             # taps of the folded location conv: [cum | prv]
PAD = (NTAP2 // 2 - 1) // 2  # the conv reaches 15 positions either side
PHASES_PER_STEP = 10   # phases of a decoder step (one span stamp each)
# What a CTA owns (contiguous, [i*n // grid, (i+1)*n // grid)): its output
# rows or units of each phase, its text positions (energies) and its
# context columns; the weight rows of its units stay in its shared memory.
OWNED = ("prenet1", "prenet2", "attn_gru", "query", "energies", "context",
         "rnn_input", "lstm1", "lstm2", "mel")


def owned(n: int, cta: int, grid: int) -> tuple:
    """[start, stop) of the ``n`` units that CTA ``cta`` of ``grid`` owns."""
    return cta * n // grid, (cta + 1) * n // grid


def _align(n: int) -> int:
    return -(-n // 16) * 16


def tts_smem_plan(D: int, Dh: int, H: int, n_mels: int, r: int, L: int,
                  grid: int, limit: int | None = SMEM_LIMIT,
                  int8_lstm: bool = False,
                  placement: str | None = None) -> dict:
    """The kernel's memory plan on ``grid`` CTAs: each phase's unit
    count, each CTA's owned ranges, the shared-memory layout every CTA
    allocates (sized for the most units any CTA owns in each phase; the
    kernel computes the same bytes and refuses a launch whose plan
    disagrees), each CTA's weight bytes, and the placement of the L-sized
    state.  ``int8_lstm`` holds an LSTM unit's rows at one byte a weight,
    then its 8 float32 scales, and adds ``lstm_hh``: the warps' maxima of
    the LSTM operands (2 a warp) and the h half of both LSTMs' gates for
    the step (2 layers x 4 gates a unit, float32), which the kernel
    computes after phase 2; its operand region also holds h1 and h2
    (float32) after phase 2's operand.

    Every CTA keeps the cumulative and previous attention of its conv
    window only (``cum``, ``prv``: its most positions and 15 either side,
    float32) and the same window staged as the conv's operand
    (``window``: bf16-rounded, act-scaled doubles), in shared memory in
    both placements.  ``placement`` "shared" keeps the L-sized
    regions (context columns, scores, pe = ploc + encp rows and encp rows)
    in shared memory too; "global" keeps them out of it: the context
    columns and encp rows are read from the kernel's inputs, and the
    scores (one slice per CTA) and pe ((L, D), each CTA its rows) go to a
    workspace of ``workspace`` bytes.  None picks "shared" when it fits
    ``limit`` (or ``limit`` is None), else "global".  Raises
    ``ValueError`` when the layout exceeds ``limit`` bytes: naming L in
    the shared placement and in a global one whose conv window does not
    fit, the grid where the fixed part alone (the window of one position)
    does not fit."""
    if grid < 1:
        raise ValueError(f"grid must be >= 1, got {grid}")
    if placement not in (None, "shared", "global"):
        raise ValueError(f"placement must be None, 'shared' or 'global', "
                         f"got {placement!r}")
    if placement is None:
        shared = tts_smem_plan(D, Dh, H, n_mels, r, L, grid, None,
                               int8_lstm, "shared")
        if limit is None or shared["bytes"] <= limit:
            return shared
        placement = "global"
    units = dict(prenet1=D, prenet2=Dh, attn_gru=D, query=D, energies=L,
                 context=D, rnn_input=H, lstm1=H, lstm2=H, mel=r * n_mels)
    # bf16 weights per unit: the rows it owns, operand segments concatenated
    row_w = dict(prenet1=n_mels, prenet2=D, attn_gru=3 * (D + Dh) + 3 * D,
                 query=D, energies=0, context=0, rnn_input=2 * D,
                 lstm1=4 * 2 * H, lstm2=4 * 2 * H, mel=H)
    # bytes a unit's rows take in shared memory
    unit_bytes = {k: 2 * n for k, n in row_w.items()}
    if int8_lstm:
        for k in ("lstm1", "lstm2"):
            unit_bytes[k] = row_w[k] + 8 * 4
    most = {k: -(-n // grid) for k, n in units.items()}
    # the operand; with int8_lstm room for h1 and h2 (f32) after phase 2's
    op_n = max(n_mels, 2 * D + Dh, 2 * H, D + H if int8_lstm else 0)
    glob = placement == "global"
    Ls, nl = (0, 0) if glob else (L, most["energies"])
    nw = most["energies"] + 2 * PAD               # a CTA's conv window
    regions = [                                   # the kernel's order
        ("operand", 8 * op_n),                    # act-scaled doubles
        ("enc_cols", 8 * most["context"] * Ls),   # act(bf16) doubles
        ("partials", 8 * NW * MAXG),
        ("window", 8 * 2 * nw),                   # [cum | prv], staged
        ("operand_f32", 4 * op_n),
        ("cum", 4 * nw), ("prv", 4 * nw), ("scores", 4 * Ls),
        ("pe_rows", 4 * nl * D),
        ("encp_rows", 4 * nl * D),
        ("own_state", 4 * (most["attn_gru"] + 2 * most["lstm1"])),
    ] + ([("lstm_hh", 4 * (2 * NW + 2 * 4 * most["lstm1"]))]
         if int8_lstm else []) + [
        ("loc_conv", 2 * NTAP2 * D),              # bf16 taps, [62][D]
    ] + [(f"w_{k}", most[k] * unit_bytes[k]) for k in OWNED if row_w[k]]
    nbytes = sum(_align(b) for _, b in regions)
    ranges = {k: [owned(n, i, grid) for i in range(grid)]
              for k, n in units.items()}
    weight_bytes = [sum((ranges[k][i][1] - ranges[k][i][0]) * unit_bytes[k]
                        for k in OWNED) for i in range(grid)]
    if limit is not None and nbytes > limit:
        # the window's regions at one position a CTA: the fixed part alone
        fixed = nbytes - sum(_align(b * nw) - _align(b * (1 + 2 * PAD))
                             for b in (16, 4, 4))
        if glob and fixed > limit:
            raise ValueError(
                f"the TTS kernel's fixed part does not fit on grid={grid} "
                f"CTAs: it needs {fixed} bytes of shared memory per CTA, the "
                f"limit is {limit}")
        raise ValueError(
            f"a text of L={L} symbols does not fit the TTS kernel's "
            f"{placement} placement on {grid} CTAs: it needs {nbytes} bytes "
            f"of shared memory per CTA"
            + (f" (its conv window of {nw} positions)" if glob else "")
            + f", the limit is {limit}")
    # the workspace: each CTA's scores (16-byte aligned), then pe (L, D)
    workspace = 4 * (-(-L // 4) * 4 * grid + L * D) if glob else 0
    return dict(grid=grid, units=units, most=most, ranges=ranges,
                regions=dict(regions), bytes=nbytes,
                weight_bytes=weight_bytes, placement=placement,
                workspace=workspace)


@functools.lru_cache(maxsize=64)
def shared_text_limit(D: int, Dh: int, H: int, n_mels: int, r: int,
                      grid: int, int8_lstm: bool = False) -> int:
    """The longest text whose shared placement fits one CTA's shared
    memory on ``grid`` CTAs (0 when none does): a text one symbol longer
    plans the global placement."""
    def fits(L):
        return tts_smem_plan(D, Dh, H, n_mels, r, L, grid, None, int8_lstm,
                             "shared")["bytes"] <= SMEM_LIMIT

    if not fits(1):
        return 0
    lo, hi = 1, 2
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:                  # fits(lo), not fits(hi)
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


@functools.lru_cache(maxsize=64)
def _plan_of(D: int, Dh: int, H: int, n_mels: int, r: int, L: int,
             grid: int, int8_lstm: bool, placement: str | None) -> tuple:
    """The plan's (shared bytes, placement, workspace bytes), once per
    shape and asked placement: building the plan takes ~0.8 ms on the
    host, as long as a 48-step launch's work on the card."""
    plan = tts_smem_plan(D, Dh, H, n_mels, r, L, grid, int8_lstm=int8_lstm,
                         placement=placement)
    return plan["bytes"], plan["placement"], plan["workspace"]


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
    int8_lstm = is_int8_lstm(packed)
    for name, n in (("D", D), ("D/2", Dh), ("H", H), ("n_mels", n_mels)):
        if n % 8:
            raise ValueError(f"the kernel takes widths that are multiples "
                             f"of 8, got {name}={n}")
    if int8_lstm and H % 16:
        raise ValueError(f"the int8_lstm kernel's 16-byte rows take H a "
                         f"multiple of 16, got H={H}")
    dev = enc.device
    shapes = _shapes(D, Dh, H, n_mels, r)
    if int8_lstm:
        shapes.update({k: (4 * H,) for k in LSTM_SCALES})
    for name, shape in shapes.items():
        t = packed[name]
        dtype = (torch.int8 if int8_lstm and name in LSTM_MATRICES
                 else torch.bfloat16 if name in MATRICES else torch.float32)
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

    ``int8_lstm`` names the variant the caller packed for, as the JAX
    kernel's flag does; a packed set of the other variant raises
    ``ValueError``.  CUDA tensors launch the kernel on the current stream
    (bf16 matrices; int8 LSTM rows with ``int8_lstm``); CPU tensors run
    :func:`tts_decode_reference`."""
    if bool(int8_lstm) != is_int8_lstm(packed):
        raise ValueError(
            f"int8_lstm={bool(int8_lstm)}, but the packed set is "
            f"{'int8_lstm' if is_int8_lstm(packed) else 'bf16'}'s")
    if enc.device.type == "cpu":
        return tts_decode_reference(packed, enc, encp, state, n_steps)
    out, glob = _launch(packed, enc, encp, state, n_steps, None)
    tts_decode.launches += 1
    tts_decode.launches_int8_lstm += int(bool(int8_lstm))
    tts_decode.launches_global += glob
    return out


def tts_decode_spans(packed: dict, enc: torch.Tensor, encp: torch.Tensor,
                     state: TTSDecodeState, n_steps: int):
    """Dev only: the kernel's instantiation that stamps the card's
    nanosecond clock (``%globaltimer``, CTA 0) at the end of each of a
    step's phases: when the next phase's input has come, and after the
    step's grid barrier; of the packed set's variant, in the plan's
    placement.  Returns :func:`tts_decode`'s outputs and the stamps,
    (n_steps, PHASES_PER_STEP) int64 on the card.  Not counted in
    ``tts_decode.launches``; nothing on the request path calls it."""
    if enc.device.type != "cuda":
        raise ValueError(f"the spans launch needs CUDA tensors, got "
                         f"{enc.device}")
    spans = torch.zeros(n_steps, PHASES_PER_STEP, dtype=torch.int64,
                        device=enc.device)
    return _launch(packed, enc, encp, state, n_steps, spans)[0], spans


def _launch(packed, enc, encp, state, n_steps, spans, placement=None):
    """One launch, uncounted; returns (outputs, 1 if in the global
    placement else 0).  ``placement`` pins the plan's placement of the
    L-sized state ("shared" or "global"; None is the plan's choice): the
    card tests and ``chip_smoke.py`` pin "global" to hold it and time it
    on short texts."""
    if enc.device.type != "cuda":
        raise ValueError(f"tts_decode runs on CUDA or CPU tensors, got "
                         f"{enc.device}")
    D, Dh, H, n_mels, r, L = _check_cuda(packed, enc, encp, state, n_steps)
    int8_lstm = is_int8_lstm(packed)

    from wavernn_tpu_torch.ops.build import load_library

    lib = load_library()
    dev = enc.device
    grid = CTAS or torch.cuda.get_device_properties(dev).multi_processor_count
    nbytes, placement, ws_bytes = _plan_of(D, Dh, H, n_mels, r, L, grid,
                                           int8_lstm, placement)
    glob = int(placement == "global")
    dims = [n_steps, L, D, Dh, H, n_mels, r, grid, int(int8_lstm), glob]
    c_dims = (ctypes.c_longlong * len(dims))(*dims)
    if (lib.tts_decode_smem_bytes(c_dims) != nbytes
            or lib.tts_decode_workspace_bytes(c_dims) != ws_bytes):
        raise RuntimeError(
            f"tts_decode kernel: its layout takes "
            f"{lib.tts_decode_smem_bytes(c_dims)} bytes and a workspace of "
            f"{lib.tts_decode_workspace_bytes(c_dims)}, the plan {nbytes} "
            f"and {ws_bytes}")
    with torch.cuda.device(dev):
        fit = ctypes.c_int(0)
        err = lib.tts_decode_max_ctas(ctypes.byref(fit), nbytes,
                                      int(int8_lstm), glob)
        if err != 0 or fit.value < grid:
            raise RuntimeError(
                f"tts_decode kernel: {grid} CTAs of {nbytes} bytes "
                f"do not fit the card at L={L} (co-resident: {fit.value}"
                + (f"; {lib.wavernn_error_string(err).decode()}" if err
                   else "") + ")")
        f32 = dict(dtype=torch.float32, device=dev)
        enc_t = enc.t().contiguous()
        state_in = torch.cat([getattr(state, f) for f in STATE_FIELDS])
        state_out = torch.empty_like(state_in)
        mels = torch.empty(n_steps, r * n_mels, **f32)
        scores = torch.empty(n_steps, L, **f32)
        stop = torch.empty(n_steps, **f32)
        # tagged activations, two slots; tag 0 is "not written yet"
        work = torch.zeros(2 * (n_mels + 4 * D + Dh + L + 5 * H),
                           dtype=torch.int64, device=dev)
        bar = torch.zeros(1, dtype=torch.int32, device=dev)
        # the global placement's cum, prv, scores and ploc (no zeroing: the
        # kernel writes each before it reads it)
        ws = torch.empty(ws_bytes // 4, **f32) if glob else None
        ptrs = [packed[k].data_ptr() for k in WEIGHT_ORDER] + [
            t.data_ptr() for t in (enc_t, encp, state_in, state_out, mels,
                                   scores, stop, work, bar)] + [
            ws.data_ptr() if glob else None]
        if spans is not None:
            ptrs.append(spans.data_ptr())
        if int8_lstm:
            ptrs += [packed[k].data_ptr() for k in LSTM_SCALES]
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.tts_decode if spans is None else lib.tts_decode_spans
        err = entry((ctypes.c_void_p * len(ptrs))(*ptrs), c_dims,
                    ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"tts_decode kernel launch failed: "
                           f"{lib.wavernn_error_string(err).decode()}")
    sizes = [getattr(state, f).shape[0] for f in STATE_FIELDS]
    new_state = TTSDecodeState(*torch.split(state_out, sizes))
    return (mels.view(n_steps, r, n_mels), scores, stop, new_state), glob


tts_decode.launches = 0
tts_decode.launches_int8_lstm = 0
tts_decode.launches_global = 0
