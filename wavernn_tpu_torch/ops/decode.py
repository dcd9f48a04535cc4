"""Autoregressive WaveRNN generation: the plain float32 decoder and the
serving ``Generator`` (ports ``wavernn_tpu/ops/decode.py``): one utterance
per launch, co-batched utterances in one launch, and streaming with an
incremental crossfade, over four ingress and four egress wire formats.

``backend='kernel'`` (the default) runs the sample loop through
``cuda_decode.decode``: the CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors.  ``backend='scan'`` runs :func:`decode_scan`, the
float32 reference decoder.  Frame and fold bucketing follow the JAX package
exactly, so both packages decode the same folds of the same lengths; the
kernel's conditioning is exactly ``target + 2*overlap`` steps long (no TPU
chunk rounding).  Each kernel launch streams bf16 or int8 feed-forward
matrices as :func:`int8_ff_policy` decides for its width; the int8 ones
quantize their operands at bounds :func:`ff_ranges` calibrates once per
Generator.

Every launch, finalize and host copy is queued on the current CUDA stream,
and nothing on the serving paths waits for the card except ``collect``:
uploads and the fold-start vectors go through pinned memory
(``non_blocking``), results come back into pinned memory with a recorded
event (:class:`HostCopy`).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.models.wavernn import (
    WaveRNN, WaveRNNConfig, from_jax_variables,
)
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.ops import fold as fold_ops
from wavernn_tpu_torch.ops import mol as mol_ops
from wavernn_tpu_torch.ops.rnn import gru_cell_step
from wavernn_tpu_torch.parallel.mesh import MeshPlan, check_plan, shard_rows


@dataclass
class DecodeWeights:
    """The sample loop's weight arrays in the math layout (in, out), as
    float32 tensors: what the JAX package's ``extract_decode_weights``
    reads from its param pytree."""

    I_w: torch.Tensor
    I_b: torch.Tensor
    gru1_w_ih: torch.Tensor
    gru1_w_hh: torch.Tensor
    gru1_b_ih: torch.Tensor
    gru1_b_hh: torch.Tensor
    gru2_w_ih: torch.Tensor
    gru2_w_hh: torch.Tensor
    gru2_b_ih: torch.Tensor
    gru2_b_hh: torch.Tensor
    fc1_w: torch.Tensor
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor
    fc2_b: torch.Tensor
    fc3_w: torch.Tensor
    fc3_b: torch.Tensor


def extract_decode_weights(model: WaveRNN) -> DecodeWeights:
    t = lambda p: p.detach().T.contiguous()
    v = lambda p: p.detach().contiguous()
    return DecodeWeights(
        I_w=t(model.I.weight), I_b=v(model.I.bias),
        gru1_w_ih=t(model.rnn1.weight_ih), gru1_w_hh=t(model.rnn1.weight_hh),
        gru1_b_ih=v(model.rnn1.bias_ih), gru1_b_hh=v(model.rnn1.bias_hh),
        gru2_w_ih=t(model.rnn2.weight_ih), gru2_w_hh=t(model.rnn2.weight_hh),
        gru2_b_ih=v(model.rnn2.bias_ih), gru2_b_hh=v(model.rnn2.bias_hh),
        fc1_w=t(model.fc1.weight), fc1_b=v(model.fc1.bias),
        fc2_w=t(model.fc2.weight), fc2_b=v(model.fc2.bias),
        fc3_w=t(model.fc3.weight), fc3_b=v(model.fc3.bias),
    )


def decode_step(w: DecodeWeights, x, h1, h2, m_t, a1_t, a2_t, a3_t, a4_t):
    """One float32 sample step: (B, 1) sample + conditioning -> logits,
    the new state, and the operands of the three feed-forward dots
    ``(xr, xr2, f1)``: xr after GRU1 (GRU2's input), after GRU2 (FC1's)
    and relu(fc1) (FC2's)."""
    xi = torch.cat([x, m_t, a1_t], dim=-1) @ w.I_w + w.I_b
    h1 = gru_cell_step(xi, h1, w.gru1_w_ih, w.gru1_w_hh, w.gru1_b_ih,
                       w.gru1_b_hh)
    xr = xi + h1
    h2 = gru_cell_step(torch.cat([xr, a2_t], dim=-1), h2, w.gru2_w_ih,
                       w.gru2_w_hh, w.gru2_b_ih, w.gru2_b_hh)
    xr2 = xr + h2
    f1 = torch.relu(torch.cat([xr2, a3_t], dim=-1) @ w.fc1_w + w.fc1_b)
    f2 = torch.relu(torch.cat([f1, a4_t], dim=-1) @ w.fc2_w + w.fc2_b)
    return f2 @ w.fc3_w + w.fc3_b, h1, h2, (xr, xr2, f1)


def _draw(logits: torch.Tensor, mode: str, n_classes: int,
          deterministic: bool, rand) -> torch.Tensor:
    """One step's (B,) samples from its logits: the mode (deterministic)
    or a draw with uniforms from ``rand(*shape)``."""
    B = logits.shape[0]
    if mode == "MOL":
        nm = logits.shape[-1] // 3
        if deterministic:
            sel = torch.argmax(logits[:, :nm], dim=-1, keepdim=True)
            sample = torch.gather(logits[:, nm:2 * nm], 1, sel)[:, 0]
            return torch.clamp(sample, -1.0, 1.0)
        return mol_ops.sample_from_discretized_mix_logistic(
            logits, rand(B, nm), rand(B))
    if deterministic:
        cls = torch.argmax(logits, dim=-1)
    else:
        u = rand(*logits.shape).clamp(1e-10, 1.0 - 1e-7)
        cls = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    return 2.0 * cls.float() / (n_classes - 1.0) - 1.0


def _check_mode(mode: str, deterministic: bool, generator) -> None:
    if mode not in ("RAW", "MOL"):
        raise ValueError(f"Unknown mode {mode}")
    if not deterministic and generator is None:
        raise ValueError("sampling mode needs a torch.Generator")


def decode_scan(weights: DecodeWeights, mels_up: torch.Tensor,
                aux: torch.Tensor, mode: str, n_classes: int,
                deterministic: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The full float32 sample loop over (B, T, feat) mels and (B, T, 4d)
    aux: (B, T) samples.  Sampling mode draws its uniforms from
    ``generator``."""
    _check_mode(mode, deterministic, generator)
    B, T, _ = mels_up.shape
    H = weights.gru1_w_hh.shape[0]
    d = aux.shape[-1] // 4
    dev = mels_up.device
    x = torch.zeros(B, 1, device=dev)
    h1 = torch.zeros(B, H, device=dev)
    h2 = torch.zeros(B, H, device=dev)
    out = torch.empty(B, T, device=dev)
    rand = lambda *shape: torch.rand(*shape, generator=generator, device=dev)
    for t in range(T):
        a = aux[:, t]
        logits, h1, h2, _ = decode_step(
            weights, x, h1, h2, mels_up[:, t], a[:, :d], a[:, d:2 * d],
            a[:, 2 * d:3 * d], a[:, 3 * d:])
        sample = _draw(logits, mode, n_classes, deterministic, rand)
        out[:, t] = sample
        x = sample[:, None]
    return out


# int8_ff calibration: the reference's decode length and headroom over the
# observed |max| (wavernn_tpu/ops/decode.py FF_CAL_STEPS, FF_CAL_MARGIN),
# its floor on a bound, and the seed of its draws (PRNGKey(17))
FF_CAL_STEPS = 4096
FF_CAL_MARGIN = 1.3
FF_CAL_FLOOR = 1e-3
FF_CAL_SEED = 17


def ff_ranges(weights: DecodeWeights, rows: torch.Tensor, mode: str,
              n_classes: int, generator: torch.Generator) -> torch.Tensor:
    """Calibrate the int8 feed-forward operands' fixed bounds: a float32
    B=1 sampling decode of the first min(N, FF_CAL_STEPS) rows of a packed
    (N, feat + 4d) conditioning stream (``cuda_decode.pack_stream``'s
    layout [mel | a1 | a2 | a3 | a4]); returns the (3,) float32
    max(|max| [xr, xr2, relu(fc1)] * FF_CAL_MARGIN, FF_CAL_FLOOR)
    (:func:`decode_step`'s three operands), on the rows' device.  The
    kernel clips at these bounds, so rare outliers past the margin
    saturate.

    The decode runs on the rows' device.  Its uniforms are drawn from
    ``generator`` up front, in one call on the generator's device, and
    moved to the rows' device once: a CPU generator gives a Generator on
    the card and one on the CPU the same draws.  On the card one step is
    captured in a CUDA graph and replayed per row: the eager step's ~50
    small launches from the host made the 4,096 steps take 4.9 s on an
    H100."""
    _check_mode(mode, False, generator)
    H = weights.gru1_w_hh.shape[0]
    d = weights.fc1_w.shape[0] - H
    feat = rows.shape[1] - 4 * d
    dev = rows.device
    rows = rows[:FF_CAL_STEPS].float()
    n_u = n_classes // 3 + 1 if mode == "MOL" else n_classes
    uniforms = torch.rand(rows.shape[0], n_u, generator=generator,
                          device=generator.device).to(dev)
    # the step's inputs and state live in fixed tensors, updated in place,
    # so that a captured step replays over them
    row = torch.zeros(1, rows.shape[1], device=dev)
    u = torch.zeros(n_u, device=dev)
    x = torch.zeros(1, 1, device=dev)
    h1 = torch.zeros(1, H, device=dev)
    h2 = torch.zeros(1, H, device=dev)
    mx = torch.zeros(3, device=dev)

    def step():
        a = [row[:, feat + i * d:feat + (i + 1) * d] for i in range(4)]
        logits, h1_, h2_, (xr, xr2, f1) = decode_step(
            weights, x, h1, h2, row[:, :feat], *a)
        mx.copy_(torch.maximum(mx, torch.stack([
            xr.abs().max(), xr2.abs().max(), f1.max()])))
        x.copy_(_draw(logits, mode, n_classes, False, _Uniforms(u))[:, None])
        h1.copy_(h1_)
        h2.copy_(h2_)

    run = step
    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()                   # warm-up outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for t in (x, h1, h2, mx):    # the warm-up's step, undone
            t.zero_()
        run = graph.replay
    for t in range(rows.shape[0]):
        row.copy_(rows[t:t + 1])
        u.copy_(uniforms[t])
        run()
    return torch.clamp(mx * FF_CAL_MARGIN, min=FF_CAL_FLOOR)


class _Uniforms:
    """``rand(*shape)`` over one step's pre-drawn uniforms: each call takes
    the next ``prod(shape)`` of them."""

    def __init__(self, row: torch.Tensor):
        self.row, self.used = row, 0

    def __call__(self, *shape) -> torch.Tensor:
        n = math.prod(shape)
        out = self.row[self.used:self.used + n].reshape(shape)
        self.used += n
        return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# The H100's int8_ff crossover: the fewest fold rows of a launch from
# which ``int8_ff=None`` ("auto") streams int8 feed-forward matrices (None
# would mean never).  Measured by ``python -m
# wavernn_tpu_torch.tools.step_opt_probe --ab`` (golden MOL, sampling,
# 2,048 steps; NVIDIA H100 80GB HBM3, 700.00 W): int8_hh against int8_hh +
# int8_ff, median us/step, 72.72 / 54.41 at 4 rows, 72.98 / 54.31 at 16,
# 73.22 / 55.34 at 48, 73.14 / 55.37 at 64, 81.32 / 62.78 at 132 and
# 157.91 / 120.81 at 240 (-22.8% to -25.6%).  Each fold row has its own
# CTA, so a row's step costs the same at every width up to one wave: int8
# wins from one row (chip_smoke.py's sweep measures 1 row too, and fails
# if the policy turns the variant on where it lost).  The TPU's 64 does not
# carry over.
FF_AUTO_MIN_ROWS: Optional[int] = 1


def int8_ff_policy(int8_ff: Optional[bool], rows: int) -> bool:
    """Whether a decode launch over ``rows`` fold rows (after the fold
    bucket) streams int8 feed-forward matrices (GRU2's input matrix, FC1
    and FC2) at calibrated activation bounds.  ``True`` and ``False``
    force it; ``None`` is the reference's ``"auto"``: on from
    :data:`FF_AUTO_MIN_ROWS` rows."""
    if int8_ff is not None:
        return bool(int8_ff)
    return FF_AUTO_MIN_ROWS is not None and rows >= FF_AUTO_MIN_ROWS


def fold_spans(needed: int, group: int, first_group: Optional[int] = None):
    """Fold-group spans for streaming decode: ``first_group`` (when set and
    smaller than ``group``) carves a small leading group so the first audio
    chunk arrives after decoding only a few folds.  Shared by
    :meth:`Generator.stream` and :meth:`Generator.stream_oneshot`, so the
    parity oracle covers the ramped schedule too."""
    spans, g0 = [], 0
    if first_group and first_group < min(group, needed):
        spans.append((0, first_group))
        g0 = first_group
    while g0 < needed:
        g1 = min(g0 + group, needed)
        spans.append((g0, g1))
        g0 = g1
    return spans


INPUT_DTYPES = ("float32", "float16", "bfloat16", "uint8")
OUTPUT_DTYPES = ("float64", "float32", "int16", "mulaw8")
_OUTPUT_NP = {"float64": np.float64, "float32": np.float32,
              "int16": np.int16, "mulaw8": np.uint8}
# uint8 ingress: one step of the [0, 1] mel, the float32 nearest to 1/255
_U8_STEP = float(np.float32(1.0 / 255.0))


class Prestaged(NamedTuple):
    """A :meth:`Generator.prestage` result: one utterance's padded mel on
    the device plus the fold geometry it was staged for."""

    mels_dev: torch.Tensor
    num_folds: int
    wave_len: int
    batched: bool
    target: int
    overlap: int


class PrestagedBatch(NamedTuple):
    """A :meth:`Generator.prestage_batch` result: every utterance's mel
    padded to one frame count, on the device, with each one's true sample
    count, bucketed frame count and fold count."""

    batch_dev: torch.Tensor
    wave_lens: tuple
    t_buckets: tuple
    fold_counts: tuple
    target: int
    overlap: int


class HostCopy:
    """A device tensor's copy into pinned host memory, queued on the
    current stream with an event that marks its end.  The pinned buffer is
    read only after that event, and never reused; a CPU tensor is its own
    copy."""

    def __init__(self, t: torch.Tensor):
        self.done = None
        if t.device.type != "cuda":
            self.host = t
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()

    def numpy(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


@dataclass
class Pending:
    """A :meth:`Generator.submit` handle: the device result, the true
    sample count and, after :meth:`Generator.prefetch`, the host copy in
    flight."""

    out_dev: torch.Tensor
    wave_len: int
    copy: Optional[HostCopy] = None


@dataclass
class PendingBatch:
    """A :meth:`Generator.submit_batch` handle: the flat device output of
    every utterance (utterance i takes ``fold_counts[i]*stride + overlap``
    samples of it, ``wave_lens[i]`` of them real) and its host copy."""

    out_dev: torch.Tensor
    wave_lens: tuple
    fold_counts: tuple
    target: int
    overlap: int
    copy: Optional[HostCopy] = None


class FeedToken(NamedTuple):
    """A queued :class:`_IncrementalUnfold` feed: the host copy of its
    finalized window, the window's first waveform sample, and the
    waveform samples [start, end) that the feed makes final."""

    copy: HostCopy
    base: int
    start: int
    end: int


@dataclass
class StreamSession:
    """One utterance's streaming front-end (:meth:`Generator.
    open_stream_session`): the conditioning its fold rows are decoded
    from, in any grouping, by its own :meth:`Generator.stream` or
    multiplexed with other sessions' rows (``infer/stream_server.py``)."""

    needed_folds: int   # real folds to decode (folds of padding skipped)
    stride: int         # fold k's conditioning starts at row k*stride
    fold_T: int         # decode steps per fold = target + 2*overlap
    wave_len: int       # true output sample count
    # kernel: one (rows, C) bf16 conditioning stream; fold rows are
    # gathered from it by start row
    packed: Optional[torch.Tensor] = None
    # scan: folded sample-rate conditioning (on the host with host_rows)
    mels_f: Optional[torch.Tensor] = None
    aux_f: Optional[torch.Tensor] = None


class _IncrementalUnfold:
    """Incremental crossfade finalization for one streaming session.

    Fold k-1 is the only earlier fold whose tail overlaps positions at or
    beyond fold k's seam, so one raw fold of left context is all the state
    needed: each feed finalizes its rows plus that context, and emits
    exactly the samples that have become final (every fold overlapping
    them decoded).  Shared by :meth:`Generator.stream` and
    ``StreamServer``.

    A feed is :meth:`feed_async` / :meth:`feed_async_dev` (queue the
    finalize and its host copy, advance the cursor) and :meth:`collect`
    (wait for that copy), so a caller can queue the next decode launch
    before it waits.  With packed egress (int16 / mulaw8) the crossfade,
    the slice of the tail fade that falls in the window and the
    quantization all run on the device; float chunks get their slice of
    the fade on the host.  The fade is in *global* waveform coordinates:
    the last min(20*hop, wave_len) samples of the whole waveform, whatever
    the chunk boundaries, so a stream equals its one-shot oracle."""

    def __init__(self, gen: "Generator", needed_folds: int, stride: int,
                 wave_len: int, overlap: int, mu_law: bool):
        self.gen = gen
        self.needed_folds = needed_folds
        self.stride = stride
        self.wave_len = wave_len
        self.overlap = overlap
        self.mu_law = mu_law
        self.g_done = 0          # folds fed so far
        self.emitted = 0         # samples emitted so far
        self._prev_fold = None   # raw samples of the last fold fed (device)
        self.packed = gen.packed_output
        self._fade = min(gen.fade_len, wave_len)
        self._env = None

    @property
    def done(self) -> bool:
        return self.emitted >= self.wave_len

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Finalize raw fold rows for folds [g_done, g_done+len(samples));
        return the newly final audio chunk (possibly empty)."""
        return self.collect(self.feed_async(samples))

    def feed_async(self, samples: np.ndarray):
        """Upload host fold rows and :meth:`feed_async_dev` them."""
        rows = self.gen._upload(torch.from_numpy(
            np.ascontiguousarray(samples, dtype=np.float32)))
        return self.feed_async_dev(rows, rows.shape[0])

    def feed_async_dev(self, rows_dev: torch.Tensor, n: int,
                       offset: int = 0):
        """Queue the finalize of ``n`` device-resident fold rows (rows
        ``offset`` .. ``offset+n`` of ``rows_dev``, e.g. one session's
        share of a multiplexed launch) behind the device-held carry of the
        previous fold, and the copy of its result to the host; returns a
        :class:`FeedToken` for :meth:`collect`.  The raw rows never leave
        the device."""
        gen, g0 = self.gen, self.g_done
        g1 = g0 + n
        window = rows_dev[offset:offset + n]
        base = 0
        if self._prev_fold is not None:
            window = torch.cat([self._prev_fold[None], window])
            base = (g0 - 1) * self.stride
        y = finalize(window, window.shape[0], mu_law=self.mu_law,
                     batched=True, overlap=self.overlap,
                     n_classes=gen.cfg.n_classes)
        if self.packed:
            y = fade_and_pack(y, self.wave_len, gen.fade_len,
                              gen.output_dtype, base=base)
        self._prev_fold = window[-1].clone()
        final_upto = self.wave_len if g1 >= self.needed_folds else min(
            self.wave_len, g1 * self.stride)
        token = FeedToken(HostCopy(y), base, self.emitted, final_upto)
        self.emitted = final_upto
        self.g_done = g1
        return token

    def collect(self, token: FeedToken) -> np.ndarray:
        """Wait for a feed's host copy and return its newly final chunk:
        wire bytes as they came (packed), or float64 with its slice of the
        tail fade."""
        _, base, emitted, final_upto = token
        out = token.copy.numpy()
        if self.packed:
            return out[emitted - base:final_upto - base].copy()
        chunk = np.array(out[emitted - base:final_upto - base],
                         dtype=np.float64)
        fade_start = self.wave_len - self._fade
        if self._fade and final_upto > fade_start:
            a = max(emitted, fade_start)
            if self._env is None:
                self._env = np.linspace(1, 0, self._fade)
            chunk[a - emitted:] *= self._env[a - fade_start:
                                             final_upto - fade_start]
        return chunk


class Generator:
    """End-to-end mel -> waveform generation.

    ``device`` is required and is never chosen silently: ``"cuda"`` raises
    when CUDA is absent.  Everything between ingress and egress runs on
    ``device``.  Serving paths:

    * one utterance: ``prestage`` -> ``submit`` -> ``prefetch`` ->
      ``collect`` (or ``__call__``);
    * co-batched utterances, one decode launch for all of their folds:
      ``prestage_batch`` -> ``submit_batch`` -> ``prefetch_batch`` ->
      ``collect_batch`` (``generate_batch`` on a :class:`PrestagedBatch`);
    * streaming: ``stream`` yields audio chunks as fold groups finish,
      ``stream_oneshot`` decodes the same groups and finalizes once;
      ``open_stream_session`` is the front-end the multi-session
      ``infer.stream_server.StreamServer`` shares.

    Wire formats: ``input_dtype`` float32 / float16 / bfloat16 (a cast,
    round-to-nearest-even) / uint8 (``round(m*255)`` on the host, times
    float32(1/255) on the device); ``output_dtype`` float64 / float32 (the
    tail fade on the host) or int16 PCM / mulaw8 (8-bit mu-law labels,
    mu = 256), faded and quantized on the device.

    ``int8_ff``: whether a kernel launch streams int8 feed-forward
    matrices, per launch width (:func:`int8_ff_policy`; ``None`` is
    "auto").  Their activation bounds are calibrated once per Generator
    (:func:`ff_ranges`, seed 17) on the first conditioning a launch that
    the policy turns on would decode: eagerly in :meth:`submit`,
    :meth:`submit_batch` and (forced) :meth:`open_stream_session`, lazily
    at a stream's first wide enough group, and at a ``StreamServer``'s
    first wide enough launch.  The Generator then keeps both packs and
    takes one per launch.  :meth:`update_variables` drops the scales.

    ``mesh``: a local ``parallel.mesh.MeshPlan`` (``make_mesh``) whose
    first device is ``device``.  Every batched launch (the one-shot, the
    co-batched serve, a stream's fold group, a ``StreamServer`` step) pads
    its fold rows to a multiple of ``n_data`` and runs one decode per
    shard, each on its own device (``parallel.mesh.shard_rows``); a shard
    of rows ``[row0, row0 + b)`` draws the random bits of those rows, so
    the kernel backend's output is the meshless Generator's byte for byte,
    sampling included.  The scan backend's shards draw their own
    seed-derived streams, as the JAX package's do; only its deterministic
    output equals the meshless one.  A single-row (unbatched) decode stays
    on the first device.  With a mesh, a raw list given to
    :meth:`generate_batch` is served co-batched, as in the JAX package.
    The int8_ff policy is applied to each shard's width (the JAX package
    turns int8_ff off under a mesh, for a TPU layout reason: its sharded
    kernel pads to 16 rows a chip); the scales are calibrated once per
    Generator and their pack copied to each device.

    ``int8_gates`` (off by default, as in the JAX package) streams the five
    big matrices as int8 with each operand quantized per row on the fly
    (``cuda_decode``'s ``int8_gates``).  It turns ``int8_hh`` and
    ``int8_ff`` off, so nothing is calibrated; the scan backend ignores
    it, as the JAX package's does.  With a mesh every shard takes the same
    pack."""

    def __init__(self, cfg: WaveRNNConfig, variables, device,
                 backend: str = "kernel", fold_bucket: int = 4,
                 frame_bucket: int = 32, deterministic: bool = False,
                 output_dtype: str = "float64", int8_hh: bool = True,
                 int8_ff: Optional[bool] = None, int8_gates: bool = False,
                 mesh: Optional[MeshPlan] = None,
                 input_dtype: str = "float32"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but CUDA is "
                               "not available")
        if backend not in ("kernel", "scan"):
            raise ValueError(f"unknown backend {backend!r}")
        self.mesh = mesh
        if mesh is not None:
            check_plan(mesh, False, "Generator(mesh=)")
            if self.device not in (mesh.device,
                                   torch.device(mesh.device.type)):
                raise ValueError(f"the Generator's device {device!r} is not "
                                 f"its mesh's first device {mesh.device}")
            self.device = mesh.device
        if input_dtype not in INPUT_DTYPES:
            raise ValueError(f"unsupported input_dtype {input_dtype!r}")
        if output_dtype not in OUTPUT_DTYPES:
            raise ValueError(f"unsupported output_dtype {output_dtype!r}")
        set_float32_policy()
        self.cfg = cfg
        self.backend = backend
        self.fold_bucket = fold_bucket
        self.frame_bucket = frame_bucket
        self.deterministic = deterministic
        self.output_dtype = output_dtype
        self.output_np_dtype = _OUTPUT_NP[output_dtype]
        self.packed_output = output_dtype in ("int16", "mulaw8")
        self.input_dtype = input_dtype
        self.int8_gates = bool(int8_gates)
        self.int8_hh = bool(int8_hh) and not self.int8_gates
        self.int8_ff = (False if self.int8_gates else
                        None if int8_ff is None else bool(int8_ff))
        self.fade_len = 20 * cfg.hop_length
        self.update_variables(variables)

    def update_variables(self, variables) -> None:
        """Swap in new model variables (e.g. a fresher checkpoint).  The
        int8_ff scales and pack are dropped with the old weights: the next
        launch that takes them calibrates on the new ones."""
        self.model = from_jax_variables(variables, self.cfg, self.device)
        self.weights = extract_decode_weights(self.model)
        self.packed = (cuda_decode.pack_weights(
            self.weights, self.cfg.feat_dims, self.cfg.aux_dims,
            int8_hh=self.int8_hh, int8_gates=self.int8_gates)
            if self.backend == "kernel" else None)
        self.ff_scales = None   # (3,) float32 bounds on the device
        self.packed_ff = None   # the pack with int8 feed-forward matrices
        self._copies = {}       # (id, device) -> (tensors, their copy)

    def _on(self, tensors: dict, dev: torch.device) -> dict:
        """``tensors`` (a pack, or the decode weights' fields) on ``dev``:
        themselves where they live, else a copy made once (another shard's
        device of the mesh)."""
        if next(v for v in tensors.values() if v is not None).device == dev:
            return tensors
        key = (id(tensors), dev)
        if key not in self._copies or self._copies[key][0] is not tensors:
            self._copies[key] = (tensors, {
                k: v if v is None else v.to(dev) for k, v in tensors.items()})
        return self._copies[key][1]

    # -- one utterance --------------------------------------------------

    def __call__(self, mels: np.ndarray, batched: bool, target: int,
                 overlap: int, mu_law: bool, seed: int = 0) -> np.ndarray:
        """mels: (n_mels, T_mel) or (1, n_mels, T_mel) normalized mel.
        Returns the waveform of length (T_mel-1)*hop."""
        return self.collect(self.submit(mels, batched, target, overlap,
                                        mu_law, seed))

    def prestage(self, mels: np.ndarray, batched: bool, target: int,
                 overlap: int) -> Prestaged:
        """Pad (context pad + frame bucket) and upload one utterance's mel
        in the ingress dtype."""
        mels, wave_len, t_bucket = self._pad_mel(mels)
        if batched:
            real_len = (t_bucket - 2 * self.cfg.pad) * self.cfg.hop_length
            num_folds, _ = fold_ops.fold_shape(real_len, target, overlap)
        else:
            num_folds = 1
        return Prestaged(self._upload(self._ingress_pack(mels)), num_folds,
                         wave_len, batched, target, overlap)

    def submit(self, mels, batched: bool, target: int, overlap: int,
               mu_law: bool, seed: int = 0) -> Pending:
        """Queue one utterance's whole mel -> waveform pipeline on the
        device; returns a handle for :meth:`collect`.  ``mels`` is a raw
        mel array or a :meth:`prestage` result."""
        mu_law = mu_law if self.cfg.mode == "RAW" else False
        if not isinstance(mels, Prestaged):
            mels = self.prestage(mels, batched, target, overlap)
        elif (mels.batched, mels.target, mels.overlap) != (batched, target,
                                                          overlap):
            raise ValueError(
                f"prestaged handle was built for batched={mels.batched}, "
                f"target={mels.target}, overlap={mels.overlap}; submit got "
                f"batched={batched}, target={target}, overlap={overlap} — "
                "the fold geometry would be stale; re-prestage")
        rows = self._pad_folds(mels.num_folds) if batched else 1
        with torch.no_grad():
            self._ensure_ff_scales(mels.mels_dev, rows)
            out = self._full_pipeline(
                mels.mels_dev, mels.num_folds, mels.wave_len, seed,
                mu_law=mu_law, batched=batched, target=target,
                overlap=overlap,
                num_folds_padded=self._pad_folds(mels.num_folds))
        return Pending(out, mels.wave_len)

    def prefetch(self, handle: Pending) -> None:
        """Queue the device -> host copy of a :meth:`submit` result into
        pinned memory without blocking."""
        if handle.copy is None:
            handle.copy = HostCopy(handle.out_dev)

    def collect(self, handle: Pending) -> np.ndarray:
        """Resolve a handle to the waveform: float64/float32 with the tail
        fade applied here, or wire bytes faded and quantized on the
        device."""
        self.prefetch(handle)
        return self._egress(handle.copy.numpy(), handle.wave_len)

    def _egress(self, out: np.ndarray, wave_len: int) -> np.ndarray:
        """One utterance's host output: the real samples, with the host
        tail fade unless the device already applied it."""
        if self.packed_output:
            return out[:wave_len].copy()
        output = np.array(out[:wave_len], dtype=self.output_np_dtype)
        fade_len = min(self.fade_len, len(output))
        if fade_len:
            output[-fade_len:] *= np.linspace(1, 0, fade_len)
        return output

    # -- co-batched utterances ------------------------------------------

    def generate_batch(self, mels_list, target: int, overlap: int,
                       mu_law: bool, seed: int = 0):
        """Serve several utterances.  A :class:`PrestagedBatch` (or any
        list, with a mesh: the sharded decode wants the wide launch) is
        served co-batched: one decode launch over every utterance's folds,
        seeded by ``seed``.  A raw list is otherwise served as a
        per-utterance submit/collect pipeline in which utterance i uses
        the seed stream (seed*1_000_003 + i) mod 2**31, as in the JAX
        package."""
        if isinstance(mels_list, PrestagedBatch) or self.mesh is not None:
            return self.collect_batch(self.submit_batch(
                mels_list, target=target, overlap=overlap, mu_law=mu_law,
                seed=seed))
        handles = []
        for i, mels in enumerate(mels_list):
            h = self.submit(mels, batched=True, target=target,
                            overlap=overlap, mu_law=mu_law,
                            seed=(seed * 1_000_003 + i) % (2 ** 31))
            self.prefetch(h)
            handles.append(h)
        return [self.collect(h) for h in handles]

    def prestage_batch(self, mels_list, target: int,
                       overlap: int) -> PrestagedBatch:
        """Pad every utterance to one bucketed frame count and upload the
        batch, so that it upsamples in one call; each utterance's true
        region is cut back out after (the convolutions reach less than the
        context pad, so the shared zero tail does not touch it)."""
        c = self.cfg
        padded = [self._pad_mel(m) for m in mels_list]
        t_glob = max(t for _, _, t in padded)
        batch = np.concatenate([np.pad(m, ((0, 0), (0, t_glob - t), (0, 0)))
                                for m, _, t in padded])
        t_buckets = tuple(t for _, _, t in padded)
        fold_counts = tuple(
            fold_ops.fold_shape((t - 2 * c.pad) * c.hop_length, target,
                                overlap)[0] for t in t_buckets)
        return PrestagedBatch(self._upload(self._ingress_pack(batch)),
                              tuple(w for _, w, _ in padded), t_buckets,
                              fold_counts, target, overlap)

    def submit_batch(self, mels_list, target: int, overlap: int,
                     mu_law: bool, seed: int = 0) -> PendingBatch:
        """Queue one co-batched serve of several utterances (one decode
        launch for all of their folds); returns a handle for
        :meth:`collect_batch`.  ``mels_list`` is a list of raw mel arrays
        or a :meth:`prestage_batch` result."""
        mu_law = mu_law if self.cfg.mode == "RAW" else False
        if not isinstance(mels_list, PrestagedBatch):
            mels_list = self.prestage_batch(mels_list, target, overlap)
        elif (mels_list.target, mels_list.overlap) != (target, overlap):
            raise ValueError(
                f"prestaged batch was built for target={mels_list.target}, "
                f"overlap={mels_list.overlap}; submit_batch got "
                f"target={target}, overlap={overlap} — the fold geometry "
                "would be stale; re-prestage")
        b = mels_list
        with torch.no_grad():
            self._ensure_ff_scales(b.batch_dev[:1],
                                   self._pad_folds(sum(b.fold_counts)))
            out = self._batch_pipeline(
                b.batch_dev, b.wave_lens, seed, t_buckets=b.t_buckets,
                target=target, overlap=overlap, fold_counts=b.fold_counts,
                mu_law=mu_law)
        return PendingBatch(out, b.wave_lens, b.fold_counts, target,
                            overlap)

    def prefetch_batch(self, handle: PendingBatch) -> None:
        """Queue the device -> host copy of a :meth:`submit_batch` result
        (one transfer for the whole batch) without blocking."""
        if handle.copy is None:
            handle.copy = HostCopy(handle.out_dev)

    def collect_batch(self, handle: PendingBatch) -> List[np.ndarray]:
        """Resolve a :meth:`submit_batch` handle to the list of
        waveforms, split on the host."""
        self.prefetch_batch(handle)
        flat = handle.copy.numpy()
        stride = handle.target + handle.overlap
        outputs, o = [], 0
        for nf, wave_len in zip(handle.fold_counts, handle.wave_lens):
            outputs.append(self._egress(flat[o:o + wave_len], wave_len))
            o += nf * stride + handle.overlap
        return outputs

    # -- streaming ------------------------------------------------------

    def open_stream_session(self, mels, target: int, overlap: int,
                            pad_to: Optional[int] = None,
                            host_rows: bool = False) -> StreamSession:
        """Prepare one utterance's streaming front-end: pad and bucket the
        mel, and build the conditioning its fold rows come from (kernel:
        one packed bf16 stream; scan: the folded sample-rate
        conditioning).  Folds that start at or past the waveform's end are
        only padding and are not decoded.

        ``pad_to`` (kernel only) pads the packed stream to that many rows,
        so that a multi-session server can copy sessions into equal slots
        of one buffer; it raises ``ValueError`` if the utterance needs
        more.  ``host_rows`` (scan only) keeps the folded conditioning on
        the host, where a server stacks rows of several sessions."""
        c = self.cfg
        mels, wave_len, t_bucket = self._pad_mel(mels)
        real_len = (t_bucket - 2 * c.pad) * c.hop_length
        num_folds, _ = fold_ops.fold_shape(real_len, target, overlap)
        fold_T = target + 2 * overlap
        stride = target + overlap
        needed_folds = min(num_folds, -(-wave_len // stride))
        geometry = dict(needed_folds=needed_folds, stride=stride,
                        fold_T=fold_T, wave_len=wave_len)
        with torch.no_grad():
            mels_dev = self._ingress_f32(
                self._upload(self._ingress_pack(mels)))
            if self.backend == "kernel":
                need = max(real_len, (needed_folds - 1) * stride + fold_T)
                if pad_to is None:
                    pad_to = need
                elif pad_to < need:
                    raise ValueError(
                        f"utterance needs {need} conditioning rows but the "
                        f"slot holds {pad_to} — raise the server's "
                        "slot_seconds or shorten the utterance")
                mels_up, aux_mel = self.model.upsample_parts(mels_dev)
                packed = _pad_rows(cuda_decode.pack_stream(
                    mels_up, aux_mel, c.total_scale), pad_to)
                if self.int8_ff:
                    # forced: calibrate now; "auto" calibrates at the first
                    # launch wide enough (launch_group, StreamServer)
                    self._calibrate_ff(packed)
                return StreamSession(packed=packed, **geometry)
            mels_up, aux = self.model.upsample_only(mels_dev)
            mels_f = fold_ops.fold_with_overlap(mels_up, target, overlap)
            aux_f = fold_ops.fold_with_overlap(aux, target, overlap)
        if host_rows:
            mels_f, aux_f = mels_f.cpu(), aux_f.cpu()
        return StreamSession(mels_f=mels_f, aux_f=aux_f, **geometry)

    def _stream_setup(self, mels, target: int, overlap: int, seed: int):
        """Open a session and build its group decoder; returns
        ``(launch_group, needed_folds, stride, wave_len)``.

        ``launch_group(g0, g1)`` queues the decode of folds g0..g1 (one
        launch, seed ``seed + g0``) and returns ``(device rows, n)``.
        :meth:`stream` and :meth:`stream_oneshot` decode through this same
        closure, so they differ only in finalization."""
        sess = self.open_stream_session(mels, target, overlap)
        stride = sess.stride

        def launch_group(g0: int, g1: int):
            n = g1 - g0
            with torch.no_grad():
                if self.backend == "kernel":
                    starts = np.zeros(self._pad_folds(n), np.int64)
                    starts[:n] = np.arange(g0, g1) * stride
                    if self._ff_policy(len(starts)):
                        self._calibrate_ff(sess.packed)
                    return self._decode_rows(sess.packed, starts,
                                             sess.fold_T, seed + g0), n
                return self._scan_rows(sess.mels_f[g0:g1],
                                       sess.aux_f[g0:g1], seed + g0), n

        return launch_group, sess.needed_folds, stride, sess.wave_len

    def stream(self, mels, target: int, overlap: int, mu_law: bool,
               group: int = 16, seed: int = 0, lookahead: int = 2,
               first_group: Optional[int] = None):
        """Streaming synthesis: yield finalized audio chunks as fold groups
        finish decoding (float64, or the packed wire dtype).

        The first chunk arrives after one group of folds decodes; a ramped
        ``first_group`` shrinks only the leading launch.  Each group's
        finalize is queued right behind its launch, and up to
        ``lookahead`` more launches are queued before a chunk is waited
        for, so the card never waits for the host and a chunk never waits
        for a later launch.  The raw rows never leave the device, only
        finished chunks do; each group finalizes with the one raw fold
        before it as context.  With deterministic decode the audio is
        sample for sample :meth:`stream_oneshot`'s."""
        mu_law = mu_law if self.cfg.mode == "RAW" else False
        launch, needed_folds, stride, wave_len = self._stream_setup(
            mels, target, overlap, seed)
        fin = _IncrementalUnfold(self, needed_folds, stride, wave_len,
                                 overlap, mu_law)
        tokens = deque()     # queued (launch, finalize) pairs
        for span in fold_spans(needed_folds, group, first_group):
            tokens.append(fin.feed_async_dev(*launch(*span)))
            while len(tokens) > max(1, lookahead):
                chunk = fin.collect(tokens.popleft())
                if len(chunk):
                    yield chunk
        while tokens:
            chunk = fin.collect(tokens.popleft())
            if len(chunk):
                yield chunk

    def stream_oneshot(self, mels, target: int, overlap: int, mu_law: bool,
                       group: int = 16, seed: int = 0,
                       first_group: Optional[int] = None) -> np.ndarray:
        """Decode the same group launches :meth:`stream` makes (same fold
        gathers, same seeds), but finalize all folds in one crossfade
        unfold: the parity oracle of the stream's incremental
        finalization.  Returns the whole waveform in the Generator's
        output dtype (packed egress faded and quantized on the device, as
        a stream's chunks are)."""
        mu_law = mu_law if self.cfg.mode == "RAW" else False
        launch, needed_folds, _, wave_len = self._stream_setup(
            mels, target, overlap, seed)
        rows = torch.cat([
            dev[:n] for dev, n in (
                launch(g0, g1)
                for g0, g1 in fold_spans(needed_folds, group, first_group))])
        y = self._finish(rows, rows.shape[0], wave_len, mu_law=mu_law,
                         batched=True, overlap=overlap)
        return self.collect(Pending(y, wave_len))

    # -- the pipelines --------------------------------------------------

    def _pad_folds(self, n: int) -> int:
        """Fold-count bucket: the decode runs this many rows, the padding
        rows masked out by :func:`finalize`; with a mesh, a multiple of
        ``n_data`` too, so that the rows split evenly over the shards."""
        n = _round_up(n, self.fold_bucket)
        if self.mesh is not None:
            n = _round_up(n, self.mesh.n_data)
        return n

    def _sharded(self, rows: int) -> bool:
        """Whether a launch over ``rows`` fold rows splits over the mesh
        (a single-row decode does not)."""
        m = self.mesh
        return m is not None and rows >= m.n_data and rows % m.n_data == 0

    def _launch_width(self, rows: int) -> int:
        """The rows of each decode a launch over ``rows`` makes: a
        shard's with a mesh."""
        return rows // self.mesh.n_data if self._sharded(rows) else rows

    # -- int8 feed-forward matrices -------------------------------------

    def _ff_policy(self, rows: int) -> bool:
        """Whether a kernel launch over ``rows`` fold rows takes the int8
        feed-forward pack (by the width of each of its decodes)."""
        return self.backend == "kernel" and int8_ff_policy(
            self.int8_ff, self._launch_width(rows))

    def _ensure_ff_scales(self, mels_dev: torch.Tensor, rows: int) -> None:
        """Calibrate once, eagerly, before a launch over ``rows`` fold rows
        that the policy turns on, on the conditioning of ``mels_dev`` (a
        (1, T, feat) uploaded wire mel: a prestaged utterance or a batch's
        first)."""
        if not self._ff_policy(rows) or self.ff_scales is not None:
            return
        mels_up, aux_mel = self.model.upsample_parts(
            self._ingress_f32(mels_dev))
        self._calibrate_ff(cuda_decode.pack_stream(
            mels_up, aux_mel, self.cfg.total_scale))

    def _calibrate_ff(self, packed: torch.Tensor) -> None:
        """The scales from a packed conditioning stream, and the int8
        feed-forward pack, unless they exist already."""
        if self.ff_scales is not None:
            return
        c = self.cfg
        with torch.no_grad():
            gen = torch.Generator().manual_seed(FF_CAL_SEED)
            self.ff_scales = ff_ranges(self.weights, packed, c.mode,
                                       c.n_classes, gen)
            self.packed_ff = cuda_decode.pack_weights(
                self.weights, c.feat_dims, c.aux_dims, int8_hh=self.int8_hh,
                int8_ff=True, ff_scales=self.ff_scales)

    def _pad_mel(self, mels):
        """(n_mels, T_mel) or (1, n_mels, T_mel) mel -> its (1, t_bucket,
        feat) float32 host array (context pad + frame bucket), the true
        sample count and t_bucket."""
        c = self.cfg
        mels = np.asarray(mels, dtype=np.float32)
        if mels.ndim == 2:
            mels = mels[None]
        if mels.shape[0] != 1:
            raise ValueError("expected a single utterance")
        mels = np.transpose(mels, (0, 2, 1))  # (1, T_mel, feat)
        wave_len = (mels.shape[1] - 1) * c.hop_length
        t_bucket = _round_up(mels.shape[1] + 2 * c.pad, self.frame_bucket)
        mels = np.pad(mels, ((0, 0), (c.pad, t_bucket - mels.shape[1] - c.pad),
                             (0, 0)))
        return mels, wave_len, t_bucket

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """Host tensor -> ``device`` without waiting for the card (through
        pinned memory)."""
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _ingress_pack(self, mels: np.ndarray) -> torch.Tensor:
        """Host float32 mel -> the wire dtype it is uploaded in: uint8
        quantizes the [0, 1] mel to 8-bit steps, bfloat16 rounds to
        nearest even (as ``jnp.bfloat16`` does), the others cast."""
        if self.input_dtype == "uint8":
            return torch.from_numpy(np.clip(
                np.round(mels * 255.0), 0.0, 255.0).astype(np.uint8))
        if self.input_dtype == "bfloat16":
            return torch.from_numpy(
                np.ascontiguousarray(mels, np.float32)).to(torch.bfloat16)
        return torch.from_numpy(mels.astype(self.input_dtype))

    def _ingress_f32(self, mels: torch.Tensor) -> torch.Tensor:
        """Uploaded wire mel -> float32 for the conditioning network."""
        mels = mels.float()
        if self.input_dtype == "uint8":
            mels = mels * _U8_STEP
        return mels

    def fold_conditioning(self, staged: Prestaged):
        """The decode kernel's inputs for one prestaged utterance: the
        fold-major (num_folds_padded, T, C) bf16 conditioning and the step
        count T, as the kernel backend's pipeline builds them."""
        with torch.no_grad():
            return self._fold_conditioning(
                self._ingress_f32(staged.mels_dev), batched=staged.batched,
                target=staged.target, overlap=staged.overlap,
                num_folds_padded=self._pad_folds(staged.num_folds))

    def _fold_conditioning(self, mels, *, batched: bool, target: int,
                           overlap: int, num_folds_padded: int):
        mels_up, aux_mel = self.model.upsample_parts(mels)
        packed = cuda_decode.pack_stream(mels_up, aux_mel,
                                         self.cfg.total_scale)
        if not batched:
            return packed[None].contiguous(), packed.shape[0]
        T = target + 2 * overlap
        stride = target + overlap
        packed = _pad_rows(packed, (num_folds_padded - 1) * stride + T)
        # padding folds read real stream rows; finalize masks their output
        starts = torch.arange(num_folds_padded, device=self.device) * stride
        return cuda_decode.fold_major_cond(packed, starts, T), T

    def _decode_rows(self, packed: torch.Tensor, starts: np.ndarray,
                     fold_T: int, seed: int) -> torch.Tensor:
        """One kernel launch over fold rows gathered from a packed
        conditioning stream at host-chosen start rows: (len(starts),
        fold_T) samples.  The fold-major gather is freed as soon as the
        launch is queued."""
        cond = cuda_decode.fold_major_cond(
            packed, self._upload(torch.from_numpy(starts)), fold_T)
        return self._kernel(cond, fold_T, seed)

    def _kernel(self, cond: torch.Tensor, T: int, seed: int):
        """One decode launch over ``cond``'s fold rows, or with a mesh
        one per shard (each keyed by its rows, so the output is the same);
        each takes the pack the int8_ff policy picks for its width."""
        if self._sharded(cond.shape[0]):
            return shard_rows(self.mesh, lambda shard, row0: self._decode(
                shard, T, seed, row0), cond)
        return self._decode(cond, T, seed, 0)

    def _decode(self, cond: torch.Tensor, T: int, seed: int, row0: int):
        """One decode over ``cond``'s rows on its device, rows
        ``[row0, row0 + len(cond))`` of its launch."""
        c = self.cfg
        packed = self.packed
        if int8_ff_policy(self.int8_ff, cond.shape[0]):
            if self.packed_ff is None:
                raise RuntimeError(
                    f"a decode over {cond.shape[0]} rows takes int8 "
                    "feed-forward matrices, but the Generator has no "
                    "calibrated scales")
            packed = self.packed_ff
        return cuda_decode.decode(self._on(packed, cond.device), cond, T,
                                  seed, mode=c.mode, n_classes=c.n_classes,
                                  deterministic=self.deterministic,
                                  row0=row0)

    def _scan_rows(self, mels_f: torch.Tensor, aux_f: torch.Tensor,
                   seed: int, bucket: bool = True) -> torch.Tensor:
        """The float32 scan decoder over folded conditioning, padded to
        the fold bucket (unless ``bucket`` is False): (rows, fold_T)
        samples."""
        pad = (self._pad_folds(mels_f.shape[0]) - mels_f.shape[0]
               if bucket else 0)
        mels_f = torch.nn.functional.pad(mels_f.to(self.device),
                                         (0, 0, 0, 0, 0, pad))
        aux_f = torch.nn.functional.pad(aux_f.to(self.device),
                                        (0, 0, 0, 0, 0, pad))
        if self._sharded(mels_f.shape[0]):
            # shard k draws from its own stream, seeded from (seed, k)
            b = mels_f.shape[0] // self.mesh.n_data
            return shard_rows(self.mesh, lambda m, a, row0: self._scan(
                m, a, seed * 1_000_003 + row0 // b), mels_f, aux_f)
        return self._scan(mels_f, aux_f, seed)

    def _scan(self, mels_f: torch.Tensor, aux_f: torch.Tensor, seed: int):
        """:func:`decode_scan` on the rows' device, its uniforms from a
        generator seeded with ``seed``."""
        c, dev = self.cfg, mels_f.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        weights = DecodeWeights(**self._on(vars(self.weights), dev))
        return decode_scan(weights, mels_f, aux_f, c.mode, c.n_classes,
                           self.deterministic, gen)

    def _finish(self, samples, num_folds: int, wave_len: int, *,
                mu_law: bool, batched: bool, overlap: int):
        """finalize, then the device-side fade and quantization of packed
        egress."""
        y = finalize(samples, num_folds, mu_law=mu_law, batched=batched,
                     overlap=overlap, n_classes=self.cfg.n_classes)
        if self.packed_output:
            y = fade_and_pack(y, wave_len, self.fade_len, self.output_dtype)
        return y

    def _full_pipeline(self, mels_padded, num_folds: int, wave_len: int,
                       seed: int, *, mu_law: bool, batched: bool,
                       target: int, overlap: int, num_folds_padded: int):
        mels = self._ingress_f32(mels_padded)
        if self.backend == "kernel":
            cond, T = self._fold_conditioning(
                mels, batched=batched, target=target, overlap=overlap,
                num_folds_padded=num_folds_padded)
            samples = self._kernel(cond, T, seed)
            del cond
        else:
            mels_up, aux = self.model.upsample_only(mels)
            if batched:
                mels_up = fold_ops.fold_with_overlap(mels_up, target,
                                                     overlap)
                aux = fold_ops.fold_with_overlap(aux, target, overlap)
            samples = self._scan_rows(mels_up, aux, seed, bucket=batched)
        return self._finish(samples, num_folds, wave_len, mu_law=mu_law,
                            batched=batched, overlap=overlap)

    def batch_conditioning(self, staged: PrestagedBatch):
        """The decode kernel's inputs for one prestaged batch: the
        fold-major (padded total folds, T, C) bf16 conditioning of every
        utterance's folds and the step count T, as the co-batched
        pipeline builds them."""
        with torch.no_grad():
            stream, starts = self._batch_streams(
                self._ingress_f32(staged.batch_dev),
                t_buckets=staged.t_buckets, target=staged.target,
                overlap=staged.overlap, fold_counts=staged.fold_counts)
            T = staged.target + 2 * staged.overlap
            return cuda_decode.fold_major_cond(
                stream, self._upload(torch.from_numpy(starts)), T), T

    def _batch_streams(self, mels, *, t_buckets: tuple, target: int,
                       overlap: int, fold_counts: tuple):
        """One batched upsample; then each utterance's packed stream, cut
        or padded to (nf-1)*stride + fold_T rows, concatenated: the stream
        and every fold's start row in it (padded to the fold bucket with
        row 0)."""
        c = self.cfg
        fold_T = target + 2 * overlap
        stride = target + overlap
        mels_up, aux_mel = self.model.upsample_parts(mels)
        streams, starts, off = [], [], 0
        for i, (t_bucket, nf) in enumerate(zip(t_buckets, fold_counts)):
            frames = t_bucket - 2 * c.pad
            s = cuda_decode.pack_stream(
                mels_up[i:i + 1, :frames * c.hop_length],
                aux_mel[i:i + 1, :frames], c.total_scale)
            need = (nf - 1) * stride + fold_T
            streams.append(_pad_rows(s, need)[:need])
            starts += [off + b * stride for b in range(nf)]
            off += need
        starts += [0] * (self._pad_folds(len(starts)) - len(starts))
        return torch.cat(streams), np.asarray(starts, np.int64)

    def _batch_pipeline(self, batch_dev, wave_lens, seed: int, *,
                        t_buckets: tuple, target: int, overlap: int,
                        fold_counts: tuple, mu_law: bool):
        """Several utterances as one launch: one batched upsample, each
        utterance's conditioning cut (kernel: its packed stream, cut or
        padded to (nf-1)*stride + fold_T rows and concatenated with start
        offsets; scan: its folds), one decode over every fold (one seed),
        then each utterance's finalize and egress into one flat output."""
        c = self.cfg
        mels = self._ingress_f32(batch_dev)
        if self.backend == "kernel":
            stream, starts = self._batch_streams(
                mels, t_buckets=t_buckets, target=target, overlap=overlap,
                fold_counts=fold_counts)
            samples = self._decode_rows(stream, starts, target + 2 * overlap,
                                        seed)
        else:
            mels_up, aux = self.model.upsample_only(mels)
            mels_f, aux_f = [], []
            for i, t_bucket in enumerate(t_buckets):
                real_len = (t_bucket - 2 * c.pad) * c.hop_length
                mels_f.append(fold_ops.fold_with_overlap(
                    mels_up[i:i + 1, :real_len], target, overlap))
                aux_f.append(fold_ops.fold_with_overlap(
                    aux[i:i + 1, :real_len], target, overlap))
            samples = self._scan_rows(torch.cat(mels_f), torch.cat(aux_f),
                                      seed)
        waves, o = [], 0
        for nf, wave_len in zip(fold_counts, wave_lens):
            waves.append(self._finish(
                samples[o:o + nf], nf, wave_len, mu_law=mu_law,
                batched=True, overlap=overlap))
            o += nf
        return torch.cat(waves)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad a (L, C) stream to at least ``rows`` rows."""
    if rows <= x.shape[0]:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0]))


def finalize(samples: torch.Tensor, num_folds: int, *, mu_law: bool,
             batched: bool, overlap: int, n_classes: int) -> torch.Tensor:
    """Mu-law expand, then mask the bucket-padding folds and crossfade-
    unfold (batched) or take the single row."""
    y = samples.float()
    if mu_law:
        mu = n_classes - 1
        y = torch.sign(y) / mu * ((1 + mu) ** torch.abs(y) - 1)
    if batched:
        mask = (torch.arange(y.shape[0], device=y.device) < num_folds)
        return fold_ops.xfade_and_unfold(y * mask[:, None].float(), overlap)
    return y[0]


def pack_wire(y: torch.Tensor, wire: str) -> torch.Tensor:
    """Float samples -> wire dtype: ``"int16"`` PCM (clipped after
    scaling, so -32768 stays reachable, as ``dsp/wavio.save_wav``
    quantizes) or ``"mulaw8"`` labels, sign(y)*log1p(255|y|)/log(256)
    mapped to [0, 255] by ``dsp/audio.encode_mu_law``'s floor(+0.5)."""
    if wire == "mulaw8":
        fx = torch.sign(y) * torch.log1p(
            255.0 * torch.clamp(torch.abs(y), 0.0, 1.0)) / math.log(256.0)
        return torch.clamp(torch.floor((fx + 1.0) / 2.0 * 255.0 + 0.5),
                           0.0, 255.0).to(torch.uint8)
    if wire != "int16":
        raise ValueError(f"unknown wire dtype {wire!r}")
    return torch.round(
        torch.clamp(y * 32767.0, -32768.0, 32767.0)).to(torch.int16)


def fade_and_pack(y: torch.Tensor, wave_len: int, fade: int,
                  wire: str = "int16", base: int = 0) -> torch.Tensor:
    """The device side of packed egress: the linear tail fade over the
    last min(fade, wave_len) samples of the waveform, then
    :func:`pack_wire`.  ``y`` holds waveform samples ``base`` ..
    ``base + len(y)``, so a streamed window takes its slice of the same
    envelope a whole waveform does."""
    L = float(min(fade, wave_len))
    j = ((torch.arange(y.shape[0], device=y.device) + base).float()
         - float(wave_len - L))
    factor = torch.clamp(1.0 - j / max(L - 1.0, 1.0), 0.0, 1.0)
    return pack_wire(y * factor, wire)
