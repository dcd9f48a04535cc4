"""Autoregressive WaveRNN generation: the plain float32 decoder and the
one-utterance serving ``Generator`` (ports ``wavernn_tpu/ops/decode.py``).

``backend='kernel'`` (the default) runs the sample loop through
``cuda_decode.decode``: the CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors.  ``backend='scan'`` runs :func:`decode_scan`, the
float32 reference decoder.  Frame and fold bucketing follow the JAX package
exactly, so both packages decode the same folds of the same lengths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

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
    """One float32 sample step: (B, 1) sample + conditioning -> logits and
    the new state."""
    xi = torch.cat([x, m_t, a1_t], dim=-1) @ w.I_w + w.I_b
    h1 = gru_cell_step(xi, h1, w.gru1_w_ih, w.gru1_w_hh, w.gru1_b_ih,
                       w.gru1_b_hh)
    x = xi + h1
    h2 = gru_cell_step(torch.cat([x, a2_t], dim=-1), h2, w.gru2_w_ih,
                       w.gru2_w_hh, w.gru2_b_ih, w.gru2_b_hh)
    x = x + h2
    x = torch.relu(torch.cat([x, a3_t], dim=-1) @ w.fc1_w + w.fc1_b)
    x = torch.relu(torch.cat([x, a4_t], dim=-1) @ w.fc2_w + w.fc2_b)
    return x @ w.fc3_w + w.fc3_b, h1, h2


def decode_scan(weights: DecodeWeights, mels_up: torch.Tensor,
                aux: torch.Tensor, mode: str, n_classes: int,
                deterministic: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The full float32 sample loop over (B, T, feat) mels and (B, T, 4d)
    aux: (B, T) samples.  Sampling mode draws its uniforms from
    ``generator``."""
    if mode not in ("RAW", "MOL"):
        raise ValueError(f"Unknown mode {mode}")
    if not deterministic and generator is None:
        raise ValueError("sampling mode needs a torch.Generator")
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
        logits, h1, h2 = decode_step(
            weights, x, h1, h2, mels_up[:, t], a[:, :d], a[:, d:2 * d],
            a[:, 2 * d:3 * d], a[:, 3 * d:])
        if mode == "MOL":
            nm = logits.shape[-1] // 3
            if deterministic:
                sel = torch.argmax(logits[:, :nm], dim=-1, keepdim=True)
                sample = torch.gather(logits[:, nm:2 * nm], 1, sel)[:, 0]
                sample = torch.clamp(sample, -1.0, 1.0)
            else:
                sample = mol_ops.sample_from_discretized_mix_logistic(
                    logits, rand(B, nm), rand(B))
        else:
            if deterministic:
                cls = torch.argmax(logits, dim=-1)
            else:
                u = rand(*logits.shape).clamp(1e-10, 1.0 - 1e-7)
                cls = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
            sample = 2.0 * cls.float() / (n_classes - 1.0) - 1.0
        out[:, t] = sample
        x = sample[:, None]
    return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def int8_ff_policy(int8_ff: Optional[bool], n_folds: int) -> bool:
    """Whether a kernel dispatch over ``n_folds`` fold rows (the kernel
    width the reference's rule reads) streams int8 feed-forward matrices
    (GRU2's input matrix, FC1 and FC2).

    The H100 policy: no, at every width, until the H100's crossover is
    measured.  ``None`` is the reference's default ``"auto"``, which turns
    them on once the kernel width reaches 64 rows
    (``wavernn_tpu/ops/decode.py:1370-1384``, ``FF_AUTO_MIN_KERNEL_B``), a
    crossover measured on the TPU; here it resolves to off, so the kernel
    streams bf16 feed-forward matrices.  ``True`` raises: the int8
    feed-forward path and its calibration are not ported."""
    if int8_ff:
        raise NotImplementedError(
            "int8_ff (calibrated int8 feed-forward matrices) is not "
            "ported yet")
    return False


class Prestaged(NamedTuple):
    """A :meth:`Generator.prestage` result: one utterance's padded mel on
    the device plus the fold geometry it was staged for."""

    mels_dev: torch.Tensor
    num_folds: int
    wave_len: int
    batched: bool
    target: int
    overlap: int


@dataclass
class Pending:
    """A :meth:`Generator.submit` handle: the device result, the true
    sample count and, after :meth:`Generator.prefetch`, the host copy in
    flight with the event that marks its end."""

    out_dev: torch.Tensor
    wave_len: int
    host: Optional[torch.Tensor] = None
    done: Optional[torch.cuda.Event] = None


class Generator:
    """End-to-end mel -> waveform generation for one utterance at a time.

    ``device`` is required and is never chosen silently: ``"cuda"`` raises
    when CUDA is absent.  Serving is ``prestage`` -> ``submit`` ->
    ``prefetch`` -> ``collect``; everything between ingress and egress runs
    on ``device``.

    ``int8_ff=None`` (the reference's ``"auto"``) resolves to bf16
    feed-forward matrices at every width: :func:`int8_ff_policy`.

    Not ported yet (each raises): ``int8_ff=True`` and its calibration,
    ``int8_gates``, a decode ``mesh``, ``bfloat16``/``uint8`` ingress and
    ``mulaw8`` egress."""

    def __init__(self, cfg: WaveRNNConfig, variables, device,
                 backend: str = "kernel", fold_bucket: int = 4,
                 frame_bucket: int = 32, deterministic: bool = False,
                 output_dtype: str = "float64", int8_hh: bool = True,
                 int8_ff: Optional[bool] = None, int8_gates: bool = False,
                 mesh=None, input_dtype: str = "float32"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but CUDA is "
                               "not available")
        if backend not in ("kernel", "scan"):
            raise ValueError(f"unknown backend {backend!r}")
        int8_ff_policy(int8_ff, fold_bucket)
        if int8_gates:
            raise NotImplementedError("int8_gates is not ported yet")
        if mesh is not None:
            raise NotImplementedError("mesh decode is not ported yet")
        if input_dtype in ("bfloat16", "uint8"):
            raise NotImplementedError(
                f"input_dtype={input_dtype!r} is not ported yet")
        if input_dtype not in ("float32", "float16"):
            raise ValueError(f"unsupported input_dtype {input_dtype!r}")
        if output_dtype == "mulaw8":
            raise NotImplementedError("output_dtype='mulaw8' is not ported yet")
        if output_dtype not in ("float64", "float32", "int16"):
            raise ValueError(f"unsupported output_dtype {output_dtype!r}")
        set_float32_policy()
        self.cfg = cfg
        self.backend = backend
        self.fold_bucket = fold_bucket
        self.frame_bucket = frame_bucket
        self.deterministic = deterministic
        self.output_dtype = output_dtype
        self.packed_output = output_dtype == "int16"
        self.input_dtype = input_dtype
        self.int8_hh = int8_hh
        self.model = from_jax_variables(variables, cfg, self.device)
        self.weights = extract_decode_weights(self.model)
        self.packed = (cuda_decode.pack_weights(
            self.weights, cfg.feat_dims, cfg.aux_dims, int8_hh=int8_hh)
            if backend == "kernel" else None)

    # -- public API -----------------------------------------------------

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
        c = self.cfg
        mels = np.asarray(mels, dtype=np.float32)
        if mels.ndim == 2:
            mels = mels[None]
        if mels.shape[0] != 1:
            raise ValueError("generate expects a single utterance")
        mels = np.transpose(mels, (0, 2, 1))  # (1, T_mel, feat)
        wave_len = (mels.shape[1] - 1) * c.hop_length
        t_bucket = _round_up(mels.shape[1] + 2 * c.pad, self.frame_bucket)
        mels = np.pad(mels, ((0, 0), (c.pad, t_bucket - mels.shape[1] - c.pad),
                             (0, 0)))
        if batched:
            real_len = (t_bucket - 2 * c.pad) * c.hop_length
            num_folds, _ = fold_ops.fold_shape(real_len, target, overlap)
        else:
            num_folds = 1
        return Prestaged(self._ingress_pack(mels).to(self.device), num_folds,
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
        with torch.no_grad():
            out = self._full_pipeline(
                mels.mels_dev, mels.num_folds, mels.wave_len, seed,
                mu_law=mu_law, batched=batched, target=target,
                overlap=overlap,
                num_folds_padded=self._pad_folds(mels.num_folds))
        return Pending(out, mels.wave_len)

    def prefetch(self, handle: Pending) -> None:
        """Start the device -> host copy of a :meth:`submit` result into
        pinned memory without blocking."""
        if self.device.type != "cuda" or handle.host is not None:
            return
        handle.host = torch.empty(handle.out_dev.shape,
                                  dtype=handle.out_dev.dtype, pin_memory=True)
        handle.host.copy_(handle.out_dev, non_blocking=True)
        handle.done = torch.cuda.Event()
        handle.done.record()

    def collect(self, handle: Pending) -> np.ndarray:
        """Resolve a handle to the waveform: float64/float32 with the tail
        fade applied here, or int16 PCM faded and quantized on the device."""
        if handle.host is not None:
            handle.done.synchronize()
            out = handle.host.numpy()
        else:
            out = handle.out_dev.cpu().numpy()
        if self.packed_output:
            return out[:handle.wave_len].copy()
        output = np.array(out, dtype=np.dtype(self.output_dtype))
        output = output[:handle.wave_len]
        fade_len = min(20 * self.cfg.hop_length, len(output))
        if fade_len:
            output[-fade_len:] *= np.linspace(1, 0, fade_len)
        return output

    def generate_batch(self, mels_list, target: int, overlap: int,
                       mu_law: bool, seed: int = 0):
        """Serve several utterances as a per-utterance submit/collect
        pipeline (no co-batching yet); utterance i uses the seed stream
        (seed*1_000_003 + i) mod 2**31, as in the JAX package."""
        handles = []
        for i, mels in enumerate(mels_list):
            h = self.submit(mels, batched=True, target=target,
                            overlap=overlap, mu_law=mu_law,
                            seed=(seed * 1_000_003 + i) % (2 ** 31))
            self.prefetch(h)
            handles.append(h)
        return [self.collect(h) for h in handles]

    # -- the pipeline ---------------------------------------------------

    def _pad_folds(self, n: int) -> int:
        """Fold-count bucket: the decode runs this many rows, the padding
        rows masked out by :func:`finalize`."""
        return _round_up(n, self.fold_bucket)

    def _ingress_pack(self, mels: np.ndarray) -> torch.Tensor:
        """Host mel -> the wire dtype it is uploaded in."""
        return torch.from_numpy(mels.astype(self.input_dtype))

    def _ingress_f32(self, mels: torch.Tensor) -> torch.Tensor:
        """Uploaded wire mel -> float32 for the conditioning network."""
        return mels.float()

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
        need = (num_folds_padded - 1) * stride + T
        if need > packed.shape[0]:
            packed = torch.nn.functional.pad(
                packed, (0, 0, 0, need - packed.shape[0]))
        # padding folds read real stream rows; finalize masks their output
        starts = torch.arange(num_folds_padded, device=self.device) * stride
        return cuda_decode.fold_major_cond(packed, starts, T), T

    def _full_pipeline(self, mels_padded, num_folds: int, wave_len: int,
                       seed: int, *, mu_law: bool, batched: bool,
                       target: int, overlap: int, num_folds_padded: int):
        c = self.cfg
        mels = self._ingress_f32(mels_padded)
        if self.backend == "kernel":
            cond, T = self._fold_conditioning(
                mels, batched=batched, target=target, overlap=overlap,
                num_folds_padded=num_folds_padded)
            samples = cuda_decode.decode(
                self.packed, cond, T, seed, mode=c.mode,
                n_classes=c.n_classes, deterministic=self.deterministic)
        else:
            mels_up, aux = self.model.upsample_only(mels)
            if batched:
                mels_f = fold_ops.fold_with_overlap(mels_up, target, overlap)
                aux_f = fold_ops.fold_with_overlap(aux, target, overlap)
                pad = num_folds_padded - mels_f.shape[0]
                mels_f = torch.nn.functional.pad(mels_f, (0, 0, 0, 0, 0, pad))
                aux_f = torch.nn.functional.pad(aux_f, (0, 0, 0, 0, 0, pad))
            else:
                mels_f, aux_f = mels_up, aux
            gen = torch.Generator(device=self.device).manual_seed(seed)
            samples = decode_scan(self.weights, mels_f, aux_f, c.mode,
                                  c.n_classes, self.deterministic, gen)
        y = finalize(samples, num_folds, mu_law=mu_law, batched=batched,
                     overlap=overlap, n_classes=c.n_classes)
        if self.packed_output:
            y = fade_and_pcm16(y, wave_len, 20 * c.hop_length)
        return y


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


def fade_and_pcm16(y: torch.Tensor, wave_len: int,
                   fade: int) -> torch.Tensor:
    """Linear tail fade over the last min(fade, wave_len) samples of the
    waveform, then 16-bit PCM (clipped after scaling, so -32768 stays
    reachable)."""
    L = float(min(fade, wave_len))
    j = (torch.arange(y.shape[0], device=y.device, dtype=torch.float32)
         - float(wave_len - L))
    factor = torch.clamp(1.0 - j / max(L - 1.0, 1.0), 0.0, 1.0)
    return torch.round(
        torch.clamp(y * factor * 32767.0, -32768.0, 32767.0)
    ).to(torch.int16)
