"""HTTP serving front-end: text in, audio out, over plain HTTP/1.1 (ports
``wavernn_tpu/infer/http_server.py``).

Built on :class:`~wavernn_tpu_torch.infer.stream_server.TTSStreamServer`,
so concurrent streamed requests are co-batched: every in-flight session's
vocoder fold rows share one decode launch per scheduling step, and each
response streams out as its audio becomes final.

Endpoints
---------
* ``GET  /health``      -> JSON ``{"ok": true, "active": N, ...}``
* ``POST /synthesize``  -> body ``{"text": "..."}`` -> complete ``audio/wav``
* ``POST /stream``      -> same body -> chunked ``audio/wav`` whose PCM
  arrives while the utterance is still decoding (the WAV header carries
  the 0xFFFFFFFF unknown-length sizes streaming players expect)

Threading model: every model call and every launch on the card runs on
one scheduler thread (:meth:`SynthesisService._loop`); HTTP handler
threads only enqueue texts and drain per-session chunk queues, and a
one-shot's consumer waits on its ``HostCopy`` event, which queues no work
on the card.  stdlib only: no web framework.
"""

from __future__ import annotations

import json
import queue
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from wavernn_tpu_torch.dsp.audio import decode_mu_law
from wavernn_tpu_torch.infer.pipeline import mel_from_linear
from wavernn_tpu_torch.infer.stream_server import TTSStreamServer
from wavernn_tpu_torch.text import text_to_sequence

_STOP = object()
_VOC_HANDLE = object()  # tags a dispatched one-shot's (sentinel, handle)
_UNKNOWN = 0xFFFFFFFF


def pcm16(x: np.ndarray) -> np.ndarray:
    """float waveform -> little-endian int16 PCM, quantized as
    ``dsp/wavio.save_wav`` and the device int16 path do (scale, then clip,
    so -32768 stays reachable).  int16 input (a chunk quantized on the
    device) passes through untouched; uint8 input is the mulaw8 wire
    format, expanded to float on the host by ``dsp.audio.decode_mu_law``."""
    x = np.asarray(x)
    if x.dtype == np.int16:
        return x.astype("<i2", copy=False)
    if x.dtype == np.uint8:
        x = decode_mu_law(x.astype(np.float64), 256, from_labels=True)
    return np.round(np.clip(x.astype(np.float64) * 32767.0,
                            -32768.0, 32767.0)).astype("<i2")


def wav_header(sample_rate: int, n_bytes: Optional[int] = None) -> bytes:
    """44-byte mono 16-bit RIFF/WAVE header (the layout ``dsp/wavio.py``
    writes).  ``n_bytes=None`` gives the 0xFFFFFFFF unknown-size variant
    of live streams, whose payload length is not known yet."""
    data = _UNKNOWN if n_bytes is None else n_bytes
    riff = _UNKNOWN if n_bytes is None else 36 + n_bytes
    return b"".join([
        b"RIFF", struct.pack("<I", riff), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                             sample_rate * 2, 2, 16),
        b"data", struct.pack("<I", data),
    ])


class SynthesisService:
    """Thread-safe text -> audio sessions over one scheduler thread.

    ``submit(text)`` may be called from any thread; it returns an iterator
    of audio chunks.  One daemon thread owns every model call and every
    launch: it admits queued texts and routes each session's chunks to its
    consumer queue.

    Two session kinds, two decode paths:

    * ``stream=True``: chunks through the :class:`TTSStreamServer`, whose
      concurrent streams share one decode launch per scheduling step.
    * ``stream=False`` (one-shot): the whole mel -> waveform decode is one
      ``Generator.submit`` plus ``prefetch``, a single launch; the
      scheduler only queues it, and the consumer's own thread waits for
      the result's host copy (``collect``), which launches nothing.
    """

    def __init__(self, pipeline, target: int = 11_000, overlap: int = 550,
                 mu_law: bool = True, group: int = 16, width: int = 64,
                 capacity: int = 4, slot_seconds: float = 30.0,
                 seed: int = 0, chunk_timeout: float = 600.0):
        self.sample_rate = pipeline.voc.cfg.sample_rate
        self.target, self.overlap, self.mu_law = target, overlap, mu_law
        self.server = TTSStreamServer(
            pipeline, target=target, overlap=overlap, mu_law=mu_law,
            group=group, width=width, capacity=capacity,
            slot_seconds=slot_seconds, seed=seed)
        self.chunk_timeout = chunk_timeout
        self._requests: "queue.Queue" = queue.Queue()
        self._queues: Dict[int, "queue.Queue"] = {}
        self._oneshots: list = []   # (tts handle, consumer queue), FIFO
        self._seed = seed
        self.served_sessions = 0      # completed sessions (both kinds)
        self.served_samples = 0       # audio samples handed to consumers
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, name="synthesis-scheduler", daemon=True)
        self._thread.start()

    # -- client side ------------------------------------------------------

    def submit(self, text: str, stream: bool = True) -> Iterator[np.ndarray]:
        """Enqueue a text; returns an iterator of audio chunks until the
        utterance completes (a one-shot session yields exactly one).  The
        iterator raises the scheduler's exception for the session (e.g. a
        text the model cannot decode)."""
        if self._stopped:
            raise RuntimeError("service is closed")
        out: "queue.Queue" = queue.Queue()
        self._requests.put((text, out, stream))
        return self._drain(out)

    def _drain(self, out: "queue.Queue") -> Iterator[np.ndarray]:
        while True:
            try:
                item = out.get(timeout=self.chunk_timeout)
            except queue.Empty:
                raise RuntimeError(
                    f"no audio chunk within {self.chunk_timeout:.0f}s — "
                    "scheduler stalled or session lost") from None
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            if isinstance(item, tuple) and item[0] is _VOC_HANDLE:
                # one-shot: the scheduler queued the decode and its host
                # copy; wait here, on the consumer's thread
                yield self._collect_oneshot(item[1])
                continue
            yield item

    def _collect_oneshot(self, handle) -> np.ndarray:
        """Resolve a one-shot vocoder handle with a bounded wait: the wait
        for the host copy cannot be interrupted, so it runs on a daemon
        thread and this caller gives up after ``chunk_timeout``."""
        result: dict = {}

        def fetch():
            try:
                result["wav"] = self.server.pipeline.voc.collect(handle)
            except Exception as e:  # noqa: BLE001 — routed to the consumer
                result["err"] = e

        t = threading.Thread(target=fetch, daemon=True,
                             name="oneshot-collect")
        t.start()
        t.join(self.chunk_timeout)
        if t.is_alive():
            raise RuntimeError(
                f"one-shot result transfer stalled >{self.chunk_timeout:.0f}s"
                " — device failure while the launch was in flight?")
        if "err" in result:
            raise result["err"]
        return result["wav"]

    @property
    def active(self) -> int:
        # read from HTTP handler threads while the scheduler changes the
        # session maps: len() reads only, never an iteration
        return (self.server.active_count
                + len(self._oneshots) + self._requests.qsize())

    def close(self):
        """Stop accepting texts and wait for in-flight sessions to finish
        (a session that cannot complete gets a service-closed error)."""
        if not self._stopped:
            self._stopped = True
            self._requests.put(_STOP)
            self._thread.join()

    # -- scheduler thread --------------------------------------------------

    def _admit(self, item) -> bool:
        """Admit one queued request; returns False on the stop sentinel."""
        if item is _STOP:
            return False
        text, out, stream = item
        try:
            if stream:
                sid = self.server.add(text)
                self._queues[sid] = out
            else:
                # one-shot: decode the mel now; the vocoder launch is
                # queued by _promote_oneshot in the loop
                pipe = self.server.pipeline
                seq = text_to_sequence(text.strip(), pipe.cleaners)
                self._oneshots.append((pipe.tts.submit(seq, r=pipe.r), out))
        except Exception as e:  # noqa: BLE001 — bad text: fail that session
            out.put(e)
        return True

    def _promote_oneshot(self):
        """Take the oldest one-shot's mel and queue its vocoder launch and
        the result's host copy."""
        handle, out = self._oneshots.pop(0)
        pipe = self.server.pipeline
        try:
            _, m_linear, _ = pipe.tts.collect(handle)
            mel = mel_from_linear(m_linear)
            if mel.shape[-1] < 2:  # sub-hop mel: no audio to decode
                self.served_sessions += 1
                out.put(None)
                return
            self._seed += 1
            vh = pipe.voc.submit(mel, True, self.target, self.overlap,
                                 self.mu_law, seed=self._seed)
            pipe.voc.prefetch(vh)
            self.served_sessions += 1
            self.served_samples += (mel.shape[-1] - 1) * pipe.voc.cfg.hop_length
            out.put((_VOC_HANDLE, vh))
            out.put(None)
        except Exception as e:  # noqa: BLE001 — fail that session only
            out.put(e)

    @torch.no_grad()  # grad mode is per thread: this one records no graph
    def _loop(self):
        running = True
        while running or self.server.active or self._oneshots:
            # block only when idle; otherwise drain admissions without
            # blocking, so waiting sessions keep decoding
            if running and not self.server.active and not self._oneshots:
                items = [self._requests.get()]
            else:
                items = []
            while True:
                try:
                    items.append(self._requests.get_nowait())
                except queue.Empty:
                    break
            for item in items:
                if not self._admit(item):
                    running = False
            if self._oneshots:
                self._promote_oneshot()
            if not self.server.active:
                continue
            try:
                served = self.server.step()
            except Exception as e:  # noqa: BLE001 — a dead scheduler
                # thread would brick the daemon: fail every in-flight
                # session, reset the server's sessions, keep serving
                for q in self._queues.values():
                    q.put(e)
                self._queues.clear()
                self.server.reset()
                continue
            for sid, chunk in served.items():
                q = self._queues.get(sid)
                if q is None:
                    continue
                if isinstance(chunk, Exception):
                    # terminal failure of this session (e.g. it exceeds
                    # the server's slot_seconds): raised by its consumer
                    self.served_sessions += 1
                    self._queues.pop(sid).put(chunk)
                elif len(chunk):
                    self.served_samples += len(chunk)
                    q.put(np.asarray(chunk))
            for sid in set(self._queues) - set(self.server.active):
                self.served_sessions += 1
                self._queues.pop(sid).put(None)
        # closed with sessions still queued or in flight: unblock consumers
        for q in self._queues.values():
            q.put(RuntimeError("service closed mid-session"))
        while True:
            try:
                item = self._requests.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                item[1].put(RuntimeError("service is closed"))


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    service: SynthesisService = None  # set by make_http_server
    quiet = True

    def log_message(self, fmt, *args):  # noqa: D102
        if not self.quiet:
            super().log_message(fmt, *args)

    # -- helpers ----------------------------------------------------------

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True  # client left; nothing to answer

    def _read_text(self) -> Optional[str]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n) or b"{}")
            text = req.get("text", "")
        except ValueError:  # json.JSONDecodeError too
            text = ""
        if not isinstance(text, str) or not text.strip():
            self._json(400, {"error": "body must be JSON with a non-empty "
                                      "'text' field"})
            return None
        return text

    def _chunk(self, data: bytes):
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

    # -- endpoints ---------------------------------------------------------

    def do_GET(self):
        if self.path == "/health":
            svc = self.service
            self._json(200, {
                "ok": True, "active": svc.active,
                "sample_rate": svc.sample_rate,
                "launches": svc.server.server.launches,
                "served_sessions": svc.served_sessions,
                "served_audio_seconds": round(
                    svc.served_samples / svc.sample_rate, 2),
            })
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path not in ("/synthesize", "/stream"):
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        text = self._read_text()
        if text is None:
            return
        try:
            session = self.service.submit(text,
                                          stream=self.path == "/stream")
            if self.path == "/synthesize":
                chunks = [pcm16(c) for c in session]
                pcm = (np.concatenate(chunks) if chunks
                       else np.zeros(0, "<i2")).tobytes()
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(44 + len(pcm)))
                    self.end_headers()
                    self.wfile.write(wav_header(self.service.sample_rate,
                                                len(pcm)) + pcm)
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
            else:
                # take the first chunk before committing to a 200, so a
                # failed session still gets a clean JSON error
                it = iter(session)
                try:
                    first = next(it)
                except StopIteration:
                    first = None
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._chunk(wav_header(self.service.sample_rate, None))
                try:
                    if first is not None:
                        self._chunk(pcm16(first).tobytes())
                        for c in it:
                            self._chunk(pcm16(c).tobytes())
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    for _ in it:  # client left: drain, free the slot
                        pass
                except Exception:  # noqa: BLE001 — after the 200, end the
                    # chunked body and drop the connection
                    self.close_connection = True
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        pass
        except Exception as e:  # noqa: BLE001 — a 500, not a hang
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


def make_http_server(service: SynthesisService, host: str = "127.0.0.1",
                     port: int = 8000, quiet: bool = True) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer serving ``service``.  Call
    ``serve_forever()`` on the result (and ``service.close()`` after
    ``shutdown()``)."""
    handler = type("Handler", (_Handler,),
                   {"service": service, "quiet": quiet})
    return ThreadingHTTPServer((host, port), handler)
