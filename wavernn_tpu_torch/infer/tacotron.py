"""Free-running Tacotron generation: text -> (mel, linear, attention)
(ports ``wavernn_tpu/infer/tacotron.py``).

Two decode backends:
  * ``kernel``: one utterance at a time through ``cuda_tts.tts_decode`` in
    chunks of :data:`CHUNK` steps (the CUDA kernel for a CUDA device, its
    plain PyTorch version on the CPU), as the JAX package's pallas path.
  * ``plain``: the model's float32 ``decode_step`` in a Python loop,
    batch-friendly, as the JAX package's XLA path.  With a mesh,
    :meth:`TTSGenerator.batch` splits the utterances over its devices and
    runs one plain decode per shard, in lockstep.
``auto`` picks the kernel on CUDA for location-sensitive attention, and the
plain decoder otherwise.  Either way the host reads each chunk's stop values
and stops once every utterance has been quiet for ``stop_patience``
consecutive frame groups; the postnet then runs over the whole
step-capped buffer, zeros past the last chunk included, and the host trims
at the first stop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.models.tacotron import (
    TacotronConfig, from_jax_variables, init_decoder_carry,
)
from wavernn_tpu_torch.ops import cuda_tts
from wavernn_tpu_torch.ops.tts_decode import (
    extract_tts_decode_weights, init_tts_decode_state, pack_tts_weights,
)
from wavernn_tpu_torch.parallel.mesh import (
    MeshPlan, check_plan, concrete_device,
)

CHUNK = 48       # kernel steps per launch, between the host's stop checks
EXIT_CHUNK = 50  # plain decoder steps between stop checks


class Decoded(NamedTuple):
    """A :meth:`TTSGenerator.submit` result, on the device."""

    mel: torch.Tensor      # (B, steps, n_mels)
    linear: torch.Tensor   # (B, steps, fft_bins)
    attn: torch.Tensor     # (B, steps / r, L)
    n_valid: torch.Tensor  # (B,) decoder steps up to the stop, inclusive
    r: int
    seq_len: int


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _n_valid(done: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) done flags -> steps up to and including the first done one,
    or n where none is."""
    first = done.to(torch.int32).argmax(dim=1) + 1
    return torch.where(done.any(dim=1), first, torch.full_like(first, n))


class TTSGenerator:
    """Text -> (mel, linear, attention) generator on an explicit ``device``
    (``"cuda"`` raises when CUDA is absent; nothing is chosen silently).

    ``stop_patience`` is the number of consecutive all-silent frame groups
    (every mel value below ``cfg.stop_threshold``) that ends a decode; 1 is
    the reference's break at the first silent group.  No stop counts in the
    first steps, while t * r <= 10.

    ``mesh``: a local ``parallel.mesh.MeshPlan`` whose first device is
    ``device``.  :meth:`batch` pads the utterance axis to a multiple of
    ``n_data`` and decodes each shard on its device (the JAX package
    shards the same batch over its mesh's ``data`` axis); a single
    utterance (:meth:`submit`) stays on the first device, through the
    kernel.

    ``int8_lstm`` (off by default, as in the JAX package) packs the
    kernel backend's LSTM matrices as int8, their operands quantized on
    the fly (``ops/tts_decode.py``): the kernel on the card, its plain
    version on the CPU.  The plain backend ignores it, as the JAX
    package's XLA backend does."""

    def __init__(self, cfg: TacotronConfig, variables, device,
                 steps: int = 2000, text_bucket: int = 32,
                 backend: str = "auto", int8_lstm: bool = False,
                 mesh: Optional[MeshPlan] = None, stop_patience: int = 1):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but CUDA is "
                               "not available")
        if stop_patience < 1:
            raise ValueError("stop_patience must be >= 1")
        self.mesh = mesh
        if mesh is not None:
            check_plan(mesh, False, "TTSGenerator(mesh=)")
            if self.device not in (mesh.device,
                                   torch.device(mesh.device.type)):
                raise ValueError(f"the TTSGenerator's device {device!r} is "
                                 f"not its mesh's first device {mesh.device}")
            self.device = mesh.device
        if backend == "auto":
            backend = ("kernel" if self.device.type == "cuda"
                       and cfg.attn_mode == "lsa" else "plain")
        if backend not in ("kernel", "plain"):
            raise ValueError(f"unknown TTS decode backend {backend!r}; "
                             "expected 'auto', 'kernel' or 'plain'")
        if backend == "kernel" and cfg.attn_mode != "lsa":
            raise ValueError(
                "the kernel backend implements location-sensitive attention "
                f"only (attn_mode='lsa'); got attn_mode={cfg.attn_mode!r}: "
                "use backend='plain' for additive attention")
        set_float32_policy()
        self.cfg = cfg
        self.backend = backend
        self.steps = steps
        self.text_bucket = text_bucket
        self.stop_patience = int(stop_patience)
        self.int8_lstm = bool(int8_lstm)
        self.model = from_jax_variables(variables, cfg, self.device)
        # the model on each device of the mesh, for the sharded batch,
        # keyed as a tensor's .device names the device
        self._models = {concrete_device(self.device): self.model}
        for d in (mesh.distinct_devices() if mesh is not None else ()):
            self._models.setdefault(d, from_jax_variables(variables, cfg, d))
        self._packed = {}      # r -> the kernel's weight set

    # -- public API -----------------------------------------------------

    def __call__(self, x, r: int, steps: int = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """x: 1-D sequence of symbol ids.  Returns (mel (n_mels, T),
        linear (fft_bins, T), attn (T/r, len(x)))."""
        return self.collect(self.submit(x, r, steps))

    def submit(self, x, r: int, steps: int = None) -> Decoded:
        """Decode one utterance on the device.  The text is zero-padded up
        to a multiple of ``text_bucket`` and attention runs over all of
        it, as in the JAX package."""
        seq_len = len(x)
        xp = torch.zeros(1, _round_up(seq_len, self.text_bucket),
                         dtype=torch.long)
        xp[0, :seq_len] = torch.as_tensor(np.asarray(x, dtype=np.int64))
        xp, steps = xp.to(self.device), self._bucket_steps(steps, r)
        with torch.no_grad():
            out = (self._run_kernel(xp, r, steps) if self.backend == "kernel"
                   else self._run_plain([xp], r, steps)[0])
        return Decoded(*out, r=r, seq_len=seq_len)

    def collect(self, handle: Decoded):
        """A :meth:`submit` result as host arrays, trimmed at the stop."""
        n_valid = int(handle.n_valid[0])
        n = n_valid * handle.r
        return (handle.mel[0, :n].T.cpu().numpy(),
                handle.linear[0, :n].T.cpu().numpy(),
                handle.attn[0, :n_valid, :handle.seq_len].cpu().numpy())

    def batch(self, seqs, r: int):
        """Several utterances in one decode batch through the plain
        decoder (the kernel serves one utterance at a time), text padded
        to the bucketed longest.  With a mesh the batch is padded to a
        multiple of ``n_data`` utterances and each shard decodes on its
        device.  Returns one (mel, linear, attn) triple per utterance,
        each trimmed at its own stop."""
        L = _round_up(max(len(s) for s in seqs), self.text_bucket)
        shards = self.mesh.n_data if self.mesh is not None else 1
        x = torch.zeros(_round_up(len(seqs), shards), L, dtype=torch.long)
        for i, s in enumerate(seqs):
            x[i, :len(s)] = torch.as_tensor(np.asarray(s, dtype=np.int64))
        devices = self.mesh.data_devices if self.mesh is not None else (
            self.device,)
        with torch.no_grad():
            outs = self._run_plain(
                [xs.to(d) for xs, d in zip(x.chunk(shards), devices)], r,
                self._bucket_steps(None, r))
        mel, linear, attn, n_valid = (
            torch.cat([o[i].cpu() for o in outs]) for i in range(4))
        mel, linear, attn = (t.numpy() for t in (mel, linear, attn))
        out = []
        for i, s in enumerate(seqs):
            nv = int(n_valid[i])
            out.append((mel[i, :nv * r].T, linear[i, :nv * r].T,
                        attn[i, :nv, :len(s)]))
        return out

    # -- the decode -----------------------------------------------------

    def _bucket_steps(self, steps, r: int) -> int:
        return _round_up(self.steps if steps is None else steps, r)

    def _packed_for(self, r: int) -> dict:
        """The kernel's weight set for ``r`` frames per step (bf16, the
        LSTM matrices int8 with ``int8_lstm``)."""
        if r not in self._packed:
            self._packed[r] = pack_tts_weights(
                extract_tts_decode_weights(self.model), r, self.cfg.n_mels,
                int8_lstm=self.int8_lstm)
        return self._packed[r]

    def _finish(self, mels_seq, scores_seq, done_seq, n_req: int, r: int,
                model=None):
        """(n, B, n_mels, r), (n, B, L), (n, B) step buffers -> the
        generator's outputs over the first n_req steps (the postnet of
        ``model``, by default the generator's)."""
        B = mels_seq.shape[1]
        mel = mels_seq[:n_req].permute(1, 0, 3, 2).reshape(
            B, n_req * r, self.cfg.n_mels)
        linear = (model or self.model).postnet_forward(mel)
        attn = scores_seq[:n_req].transpose(0, 1)
        return mel, linear, attn, _n_valid(done_seq[:n_req].T, n_req)

    def _run_plain(self, xs, r: int, steps: int) -> list:
        """The plain decoder over one or more batches of symbol ids, each
        on its own device (a mesh's shards) with the model there, in
        lockstep: each chunk of steps is queued on every device before
        the host reads a stop flag, and every batch runs until all
        utterances of all of them are done, as one batch would.  Returns
        (mel, linear, attn, n_valid) per batch."""
        n_req = steps // r
        chunk = min(EXIT_CHUNK, n_req)
        runs = [_PlainRun(self._models[x.device], self.cfg, x, r,
                          _round_up(n_req, chunk)) for x in xs]
        for t0 in range(0, runs[0].n_iters, chunk):
            if all(bool(run.done.all()) for run in runs):
                break
            for run in runs:
                run.advance(t0, t0 + chunk, self.stop_patience)
        return [self._finish(run.mels_buf, run.scores_buf, run.done_buf,
                             n_req, r, run.model) for run in runs]

    def _run_kernel(self, x: torch.Tensor, r: int, steps: int):
        c = self.cfg
        if x.shape[0] != 1:
            raise ValueError("the kernel backend decodes one utterance")
        L = x.shape[1]
        n_req = steps // r
        n_iters = _round_up(n_req, CHUNK)
        enc, encp = self.model.encode(x)
        enc, encp = enc[0].contiguous(), encp[0].contiguous()
        packed = self._packed_for(r)
        state = init_tts_decode_state(c.decoder_dims, c.lstm_dims, L,
                                      c.n_mels, self.device)
        mels_buf = torch.zeros(n_iters, r, c.n_mels, device=self.device)
        scores_buf = torch.zeros(n_iters, L, device=self.device)
        done_buf = np.zeros(n_iters, dtype=bool)
        done, quiet = False, 0
        for t0 in range(0, n_iters, CHUNK):
            if done:
                break
            mels_c, scores_c, stop_c, state = cuda_tts.tts_decode(
                packed, enc, encp, state, CHUNK, int8_lstm=self.int8_lstm)
            mels_buf[t0:t0 + CHUNK] = mels_c
            scores_buf[t0:t0 + CHUNK] = scores_c
            for k, s in enumerate(stop_c.cpu().numpy()):
                t = t0 + k
                quiet = quiet + 1 if (s < c.stop_threshold and t * r > 10) else 0
                done = done or quiet >= self.stop_patience
                done_buf[t] = done
        done_t = torch.from_numpy(done_buf).to(self.device)
        return self._finish(mels_buf.permute(0, 2, 1)[:, None],
                            scores_buf[:, None], done_t[:, None], n_req, r)


class _PlainRun:
    """One batch's state in the plain decoder: the encoder outputs, the
    carry and the step buffers on the batch's device."""

    def __init__(self, model, cfg: TacotronConfig, x: torch.Tensor, r: int,
                 n_iters: int):
        B, L = x.shape
        dev = x.device
        self.model, self.cfg, self.r, self.n_iters = model, cfg, r, n_iters
        self.enc, self.encp = model.encode(x)
        self.carry = init_decoder_carry(cfg, B, L, dev)
        self.prev = torch.zeros(B, cfg.n_mels, device=dev)
        self.done = torch.zeros(B, dtype=torch.bool, device=dev)
        self.quiet = torch.zeros(B, dtype=torch.int32, device=dev)
        self.mels_buf = torch.zeros(n_iters, B, cfg.n_mels, r, device=dev)
        self.scores_buf = torch.zeros(n_iters, B, L, device=dev)
        self.done_buf = torch.zeros(n_iters, B, dtype=torch.bool, device=dev)

    def advance(self, t0: int, t1: int, stop_patience: int) -> None:
        """Queue decoder steps t0 .. t1."""
        c, r = self.cfg, self.r
        for t in range(t0, t1):
            self.carry, (mels, scores) = self.model.decode_step(
                self.carry, self.enc, self.encp, self.prev, r)
            self.prev = mels[:, :, -1]
            group_quiet = (mels < c.stop_threshold).flatten(1).all(dim=1)
            self.quiet = torch.where(group_quiet, self.quiet + 1,
                                     torch.zeros_like(self.quiet))
            self.done = self.done | ((self.quiet >= stop_patience)
                                     & (t * r > 10))
            self.mels_buf[t], self.scores_buf[t], self.done_buf[t] = (
                mels, scores, self.done)
