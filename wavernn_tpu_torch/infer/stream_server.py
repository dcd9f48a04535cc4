"""Multi-session streaming vocoder server: concurrent utterances, one decode
launch per step (ports ``StreamServer`` of
``wavernn_tpu/infer/stream_server.py``).

``Generator.stream`` turns one utterance into a chunk stream.  This module
multiplexes many concurrent streams onto one card: each step decodes fold
rows drawn from every active session in one decode launch, then finalizes
each session's newly final audio with the incremental crossfade
``Generator.stream`` uses.  The kernel gives each fold row its own CTA, so
up to one wave of SMs a launch of many sessions' rows costs about what one
session's costs.

Backends:

* kernel: each session's packed bf16 conditioning stream is copied into
  its slot of one preallocated ``(capacity * slot_len, C)`` device buffer;
  a launch gathers every selected fold's window from that buffer by start
  row (slot base + fold * stride).
* scan: sessions keep their folded conditioning on the host; a launch
  stacks the selected rows into one batch for the float32 scan decoder.

Scheduling is least-progress-first: each step, the sessions with the
fewest dispatched folds contribute up to ``group`` folds each until
``width`` rows are filled.

Determinism: with ``Generator(deterministic=True)`` each session's output
is byte for byte that session's own ``Generator.stream`` (a row's decode
does not depend on the other rows of its launch) when both launches take
the same pack: with ``int8_ff``, the same calibrated Generator and the
same policy decision at both widths.  Sampled output depends
on the batch's composition: a launch's random bits are keyed by a row's
index within it, and its seed is ``seed * 1000003 + launches``.

:class:`TTSStreamServer` puts the Tacotron decode in front of the server:
text in, each session's audio chunks out as they decode.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from wavernn_tpu_torch.infer.pipeline import TTSPipeline, mel_from_linear
from wavernn_tpu_torch.ops.decode import Generator, _IncrementalUnfold
from wavernn_tpu_torch.text import text_to_sequence


class _Session:
    """Internal per-session record."""

    def __init__(self, sid: int, sess, fin: _IncrementalUnfold,
                 slot: Optional[int]):
        self.sid = sid
        self.sess = sess          # ops.decode.StreamSession
        self.fin = fin            # incremental finalizer (owns progress)
        self.slot = slot          # slot index in the buffer (kernel)
        self.dispatched = 0       # folds already in a dispatched launch


class StreamServer:
    """Serve many concurrent mel -> waveform streams through one Generator.

    Parameters
    ----------
    gen : Generator
        The decode runtime (kernel or scan backend).  With packed egress
        (int16 / mulaw8) chunks arrive as device-faded wire bytes;
        otherwise float64, as ``Generator.stream`` gives them.
    target, overlap : int
        Fold geometry, shared by every session.
    mu_law : bool
        RAW-mode mu-law expansion (ignored in MOL mode).
    group : int
        Most folds one session contributes per step (the chunk cadence).
    width : int
        Most fold rows per launch.
    capacity : int
        Most concurrent sessions (kernel: slots in the shared buffer).
    slot_seconds : float
        Kernel only: audio seconds of conditioning a slot holds; a slot is
        ``slot_seconds * sample_rate + target + 2 * overlap`` rows, and a
        longer utterance is refused.
    seed : int
        Base of the per-launch seeds (sampling decode).
    """

    def __init__(self, gen: Generator, target: int, overlap: int,
                 mu_law: bool, group: int = 16, width: int = 64,
                 capacity: int = 4, slot_seconds: float = 30.0,
                 seed: int = 0):
        self.gen = gen
        self.target = target
        self.overlap = overlap
        self.mu_law = mu_law if gen.cfg.mode == "RAW" else False
        self.group = group
        self.width = width
        self.capacity = capacity
        self.seed = seed
        self.fold_T = target + 2 * overlap

        self._sessions: Dict[int, _Session] = {}
        self._next_sid = 0
        self._launches = 0
        # one launch kept in flight ahead of the one being collected:
        # step() dispatches the next launch (and its finalizes) before it
        # waits for the current one's chunks.  Scheduling reads each
        # session's dispatched fold count, so no fold is decoded twice.
        self._inflight = None     # [(session, feed token)] or None

        if gen.backend == "kernel":
            c = gen.cfg
            self.slot_len = int(slot_seconds * c.sample_rate) + self.fold_T
            self._free_slots = list(range(capacity))
            self._buffer = torch.zeros(
                capacity * self.slot_len, c.feat_dims + c.aux_dims * 4,
                dtype=torch.bfloat16, device=gen.device)

    # -- session lifecycle ------------------------------------------------

    def add(self, mels) -> int:
        """Admit an utterance; returns its session id.  Raises
        RuntimeError at capacity and ValueError when the utterance does
        not fit a slot or is too short to give a sample."""
        if len(self._sessions) >= self.capacity:
            raise RuntimeError(
                f"server at capacity ({self.capacity} sessions); call "
                "step() until one finishes")
        kernel = self.gen.backend == "kernel"
        sess = self.gen.open_stream_session(
            mels, self.target, self.overlap,
            pad_to=self.slot_len if kernel else None, host_rows=True)
        if sess.needed_folds == 0:
            raise ValueError("utterance too short to produce any samples")
        slot = None
        if kernel:
            slot = self._free_slots.pop()
            base = slot * self.slot_len
            self._buffer[base:base + self.slot_len].copy_(sess.packed)
            sess.packed = None  # its rows now live in the buffer
        fin = _IncrementalUnfold(
            self.gen, sess.needed_folds, sess.stride, sess.wave_len,
            self.overlap, self.mu_law)
        sid = self._next_sid
        self._next_sid += 1
        self._sessions[sid] = _Session(sid, sess, fin, slot)
        return sid

    @property
    def active(self) -> List[int]:
        return sorted(self._sessions)

    @property
    def launches(self) -> int:
        """Decode launches issued so far: with N concurrent sessions this
        grows about N times slower than the sum of their solo streams'
        launches."""
        return self._launches

    def reset(self) -> None:
        """Drop every session and free every slot (recovery after a
        failed :meth:`step`; admissions overwrite their slot, so the
        buffer needs no clearing)."""
        self._sessions.clear()
        self._inflight = None
        if self.gen.backend == "kernel":
            self._free_slots = list(range(self.capacity))

    # -- scheduling -------------------------------------------------------

    def _schedule(self):
        """(session, g0, g1) work items: least-progress sessions first, up
        to ``group`` folds each and ``width`` rows in all.  Progress is the
        dispatched fold count, so the lookahead never schedules a fold
        twice."""
        order = sorted(self._sessions.values(),
                       key=lambda s: (s.dispatched, s.sid))
        items, used = [], 0
        for s in order:
            if used >= self.width:
                break
            g0 = s.dispatched
            g1 = min(g0 + self.group, s.sess.needed_folds,
                     g0 + (self.width - used))
            if g1 > g0:
                items.append((s, g0, g1))
                used += g1 - g0
        return items, used

    def _dispatch(self):
        """Schedule and queue one multiplexed decode launch, and behind it
        each served session's finalize and host copy; returns [(session,
        feed token)], or None when no session has undispatched folds."""
        items, used = self._schedule()
        if not items:
            return None
        seed = self.seed * 1000003 + self._launches
        self._launches += 1
        gen = self.gen
        with torch.no_grad():
            if gen.backend == "kernel":
                starts = np.zeros(gen._pad_folds(used), np.int64)
                o = 0
                for s, g0, g1 in items:
                    starts[o:o + g1 - g0] = (s.slot * self.slot_len
                                             + np.arange(g0, g1)
                                             * s.sess.stride)
                    o += g1 - g0
                if gen._ff_policy(len(starts)):
                    # int8_ff: the first launch wide enough calibrates on
                    # the first served session's slot rows
                    b0 = items[0][0].slot * self.slot_len
                    gen._calibrate_ff(self._buffer[b0:b0 + self.slot_len])
                rows = gen._decode_rows(self._buffer, starts, self.fold_T,
                                        seed)
            else:
                rows = gen._scan_rows(
                    torch.cat([s.sess.mels_f[g0:g1] for s, g0, g1 in items]),
                    torch.cat([s.sess.aux_f[g0:g1] for s, g0, g1 in items]),
                    seed)
        tokens, o = [], 0
        for s, g0, g1 in items:
            s.dispatched = g1
            tokens.append((s, s.fin.feed_async_dev(rows, g1 - g0, offset=o)))
            o += g1 - g0
        return tokens

    def step(self) -> Dict[int, np.ndarray]:
        """Serve one multiplexed launch and return each served session's
        newly final audio chunk (a session whose last chunk this is frees
        its slot).  Empty dict when idle.

        The next launch is queued before this one's chunks are waited for,
        and each launch's finalizes are queued right behind it, so the
        card decodes while the host takes chunks and a chunk waits only
        for its own launch.  Each session's rows and feed order are those
        of the unpipelined server."""
        if self._inflight is None:
            self._inflight = self._dispatch()
            if self._inflight is None:
                return {}
        tokens = self._inflight
        self._inflight = self._dispatch()  # queue the next before waiting

        chunks: Dict[int, np.ndarray] = {}
        for s, token in tokens:
            chunk = s.fin.collect(token)
            if len(chunk):
                chunks[s.sid] = chunk
            if token.end >= s.fin.wave_len:   # the session's last chunk
                if s.slot is not None:
                    self._free_slots.append(s.slot)
                del self._sessions[s.sid]
        return chunks

    def run(self, mels_list) -> List[np.ndarray]:
        """Admit every utterance (waiting for free slots as sessions
        finish), step until all complete, and return each utterance's
        waveform in input order."""
        pieces: Dict[int, List[np.ndarray]] = {}
        sids: List[int] = []
        pending = list(mels_list)
        while pending or self._sessions:
            while pending and len(self._sessions) < self.capacity:
                sid = self.add(pending.pop(0))
                sids.append(sid)
                pieces[sid] = []
            for sid, chunk in self.step().items():
                pieces[sid].append(chunk)
        return [np.concatenate(pieces[sid]) for sid in sids]


class TTSStreamServer:
    """Multi-session two-stage streaming server: concurrent text -> speech
    sessions on one card, audio chunks out as they decode (ports
    ``TTSStreamServer`` of ``wavernn_tpu/infer/stream_server.py``).

    Composes ``TTSGenerator.submit`` / ``collect`` (the text -> mel decode)
    with a :class:`StreamServer` (every session's fold rows co-batched into
    one decode launch per step).  :meth:`add` runs a text's mel decode;
    :meth:`step` admits finished mels into free vocoder slots, oldest
    first, then serves one co-batched vocoder launch and returns each
    session's newly final audio.

    Notes
    -----
    * The port's text -> mel decode reads each 48-step chunk's stop values
      on the host, so :meth:`add` returns only when the mel is done (the
      JAX package's returns once the decode is queued).  On one CUDA
      stream its first stop read also waits for the vocoder launch the
      server keeps in flight.
    * A text whose mel has fewer than 2 frames completes with one empty
      chunk rather than raising.
    * ``deterministic`` generators make each session's audio that of the
      unmultiplexed two-stage path (text -> mel -> ``Generator.stream``).
    """

    def __init__(self, pipeline: TTSPipeline, target: int, overlap: int,
                 mu_law: bool, group: int = 16, width: int = 64,
                 capacity: int = 4, slot_seconds: float = 30.0,
                 seed: int = 0):
        if not isinstance(pipeline, TTSPipeline):
            raise TypeError(f"expected a TTSPipeline, got {type(pipeline)}")
        self.pipeline = pipeline
        self.server = StreamServer(
            pipeline.voc, target=target, overlap=overlap, mu_law=mu_law,
            group=group, width=width, capacity=capacity,
            slot_seconds=slot_seconds, seed=seed)
        self._tts_pending: List[tuple] = []   # (sid, tts handle), FIFO
        self._voc_to_sid: Dict[int, int] = {}
        self._next_sid = 0
        # the empty chunk takes the vocoder's serving dtype
        voc = pipeline.voc
        self._zero = np.zeros(0, voc.output_np_dtype if voc.packed_output
                              else np.float64)

    def add(self, text: str) -> int:
        """Admit a text and decode its mel; returns the session id."""
        seq = text_to_sequence(text.strip(), self.pipeline.cleaners)
        handle = self.pipeline.tts.submit(seq, r=self.pipeline.r)
        sid = self._next_sid
        self._next_sid += 1
        self._tts_pending.append((sid, handle))
        return sid

    @property
    def active(self) -> List[int]:
        return sorted([sid for sid, _ in self._tts_pending]
                      + list(self._voc_to_sid.values()))

    @property
    def active_count(self) -> int:
        """In-flight session count: len() reads only, safe to call from
        other threads while the scheduler thread changes the maps."""
        return len(self._tts_pending) + len(self._voc_to_sid)

    def reset(self) -> None:
        """Drop every in-flight session (recovery after a failed
        :meth:`step`)."""
        self._tts_pending.clear()
        self._voc_to_sid.clear()
        self.server.reset()

    def step(self) -> Dict[int, np.ndarray]:
        """Admit finished mels into free vocoder slots, then serve one
        co-batched vocoder launch.  Returns each served session's newly
        final audio: an empty array marks a session whose mel was too
        short to give any, an ``Exception`` value a session that failed
        admission (e.g. its utterance exceeds ``slot_seconds``), terminal
        for that session only."""
        out: Dict[int, np.ndarray] = {}
        while (self._tts_pending
               and len(self.server.active) < self.server.capacity):
            sid, handle = self._tts_pending.pop(0)
            _, m_linear, _ = self.pipeline.tts.collect(handle)
            mel = mel_from_linear(m_linear)
            if mel.shape[-1] < 2:  # sub-hop mel: nothing to vocode
                out[sid] = self._zero
                continue
            try:
                voc_sid = self.server.add(mel)
            except ValueError as e:
                # fail this session only: the error is its terminal result
                out[sid] = e
                continue
            self._voc_to_sid[voc_sid] = sid
        served = self.server.step()
        live = set(self.server.active)
        for voc_sid in list(self._voc_to_sid):
            sid = self._voc_to_sid[voc_sid]
            if voc_sid in served:
                out[sid] = served[voc_sid]
            if voc_sid not in live:  # finished: unmap, and report the
                # completion even when its last chunk is empty
                del self._voc_to_sid[voc_sid]
                out.setdefault(sid, self._zero)
        return out

    def run(self, texts) -> List[np.ndarray]:
        """Admit every text, step until all sessions complete, and return
        each text's waveform in input order.  A session's failure
        raises."""
        sids = [self.add(t) for t in texts]
        pieces: Dict[int, List[np.ndarray]] = {sid: [] for sid in sids}
        while self.active:
            for sid, chunk in self.step().items():
                if isinstance(chunk, Exception):
                    raise chunk
                pieces[sid].append(chunk)
        return [np.concatenate(pieces[sid]) if pieces[sid] else self._zero
                for sid in sids]
