"""The port's HTTP serving front-end (``wavernn_tpu_torch/infer/
http_server.py``), mirroring ``tests/test_http_server.py``.

Spins the real ThreadingHTTPServer on a loopback port (port 0) over the
port's tiny two-stage pipeline on the CPU (the committed tiny golden
Tacotron and tiny RAW golden WaveRNN, deterministic, target 200 / overlap
28) and drives it with stdlib ``http.client``: health, a one-shot
``/synthesize`` WAV, the chunked ``/stream``, mixed and concurrent
sessions, the error paths, draining on close and surviving a failed step.
``pcm16`` and ``wav_header`` must give the JAX package's bytes.  The JAX
file's mesh case has its counterpart: a service over a pipeline whose
vocoder shards its fold rows over a two-shard CPU mesh serves the bytes
of the meshless service."""

import http.client
import json
import struct
import threading

import numpy as np
import pytest

from wavernn_tpu_torch.infer.http_server import (SynthesisService,
                                                 make_http_server, pcm16,
                                                 wav_header)
from wavernn_tpu_torch.infer.pipeline import mel_from_linear
from wavernn_tpu_torch.text import text_to_sequence
from tests.test_torch_stream import OVERLAP, TARGET
from wavernn_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_tts_stream_server import tiny_pipeline
from tests.torch_cpu import one_torch_thread  # noqa: F401

SERVICE = dict(target=TARGET, overlap=OVERLAP, mu_law=True, group=16,
               width=48, capacity=2, slot_seconds=2.0, chunk_timeout=60.0)


def serving(pipe):
    """(service, httpd) with the server thread started."""
    service = SynthesisService(pipe, **SERVICE)
    httpd = make_http_server(service, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return service, httpd


def stop(service, httpd):
    httpd.shutdown()
    httpd.server_close()
    service.close()


@pytest.fixture(scope="module")
def server():
    service, httpd = serving(tiny_pipeline())
    yield httpd.server_address[1], service
    stop(service, httpd)


def _post(port, path, body, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    status, ctype = resp.status, resp.getheader("Content-Type")
    conn.close()
    return status, ctype, data


def _parse_wav(data):
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    assert data[12:16] == b"fmt "
    _, fmt, ch, sr, _, _, bits = struct.unpack("<IHHIIHH", data[16:36])
    assert (fmt, ch, bits) == (1, 1, 16)
    assert data[36:40] == b"data"
    return sr, np.frombuffer(data[44:], "<i2")


def test_pcm16_and_wav_header_match_jax():
    from wavernn_tpu.infer import http_server as jax_http

    rng = np.random.default_rng(0)
    for x in (rng.uniform(-1.2, 1.2, 999),
              rng.uniform(-1, 1, 64).astype(np.float32),
              rng.integers(-32768, 32768, 50).astype(np.int16),
              rng.integers(0, 256, 300).astype(np.uint8),
              np.array([-1.0, 1.0, -1.00004, 0.0])):
        assert pcm16(x).tobytes() == jax_http.pcm16(x).tobytes()
    for sr, n in ((22050, None), (22050, 0), (16000, 12345)):
        assert wav_header(sr, n) == jax_http.wav_header(sr, n)


def test_health(server):
    port, service = server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/health")
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    conn.close()
    assert resp.status == 200
    assert payload["ok"] is True and payload["active"] == 0
    assert payload["sample_rate"] == service.sample_rate
    assert payload["launches"] == service.server.server.launches
    assert payload["served_sessions"] == service.served_sessions
    assert payload["served_audio_seconds"] == round(
        service.served_samples / service.sample_rate, 2)


def test_synthesize_returns_wav(server):
    port, service = server
    status, ctype, data = _post(port, "/synthesize", {"text": "abcde"})
    assert status == 200 and ctype == "audio/wav"
    sr, pcm = _parse_wav(data)
    assert sr == service.sample_rate
    assert struct.unpack("<I", data[40:44])[0] == 2 * len(pcm)
    assert len(pcm) > 0 and np.abs(pcm.astype(np.int32)).max() > 0


def test_synthesize_matches_direct_pipeline(server):
    """/synthesize is one vocoder launch per request: its PCM equals a
    one-shot of the service's own pipeline called directly, outside the
    service (the same Generator, so the same int8_ff bounds, which a
    Generator calibrates on the first utterance it serves)."""
    port, service = server
    _, _, got = _post(port, "/synthesize", {"text": "edcba"})
    pipe = service.server.pipeline
    _, m_linear, _ = pipe.tts(text_to_sequence("edcba", ["english_cleaners"]),
                              r=pipe.r)
    want = pipe.voc(mel_from_linear(m_linear), batched=True, target=TARGET,
                    overlap=OVERLAP, mu_law=True)
    assert got[44:] == pcm16(want).tobytes()


def test_stream_is_chunked_and_deterministic(server):
    """/stream carries the unknown-length header, as many samples as
    /synthesize of the same text, and repeats byte for byte."""
    port, _ = server
    _, _, want = _post(port, "/synthesize", {"text": "abcde"})
    status, ctype, got = _post(port, "/stream", {"text": "abcde"})
    assert status == 200 and ctype == "audio/wav"
    assert struct.unpack("<I", got[40:44])[0] == 0xFFFFFFFF
    assert len(got[44:]) == len(want[44:]) > 0
    _, _, again = _post(port, "/stream", {"text": "abcde"})
    assert again[44:] == got[44:]


def test_mixed_stream_and_oneshot_sessions(server):
    """A streaming and a one-shot session in flight together both complete
    with their solo bytes."""
    port, _ = server
    results = {}

    def run(path, key):
        results[key] = _post(port, path, {"text": "abcd"})

    threads = [threading.Thread(target=run, args=("/stream", "s")),
               threading.Thread(target=run, args=("/synthesize", "o"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    _, _, solo_stream = _post(port, "/stream", {"text": "abcd"})
    _, _, solo_one = _post(port, "/synthesize", {"text": "abcd"})
    assert results["s"][2][44:] == solo_stream[44:]
    assert results["o"][2][44:] == solo_one[44:]


def test_concurrent_requests_share_the_service(server):
    """Four concurrent requests each get the bytes a solo request gets."""
    port, service = server
    texts = ["abc", "edcba", "abcde", "bcd"]
    results = {}

    def run(i):
        results[i] = _post(port, "/stream" if i % 2 else "/synthesize",
                           {"text": texts[i]})

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    for i, t in enumerate(texts):
        status, _, data = results[i]
        assert status == 200
        _, pcm = _parse_wav(data)
        assert len(pcm) > 0 and np.abs(pcm.astype(np.int32)).max() > 0
        _, _, solo = _post(port, "/stream" if i % 2 else "/synthesize",
                           {"text": t})
        assert data[44:] == solo[44:], t
    assert service.active == 0


def test_error_paths(server):
    port, _ = server
    status, _, data = _post(port, "/synthesize", {"no_text": 1})
    assert status == 400 and b"text" in data
    status, _, _ = _post(port, "/stream", {"text": "   "})
    assert status == 400
    status, _, _ = _post(port, "/nonsense", {"text": "x"})
    assert status == 404
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/nonsense")
    assert conn.getresponse().status == 404
    conn.close()
    # a text of symbols the model has none of: the session fails, the
    # client gets a 500 with a JSON error, and the service keeps serving
    for path in ("/synthesize", "/stream"):
        status, ctype, data = _post(port, path, {"text": "{QQ9}"})
        assert status == 500 and ctype == "application/json"
        assert "error" in json.loads(data)
    status, _, _ = _post(port, "/synthesize", {"text": "abc"})
    assert status == 200


def test_service_close_drains_in_flight_sessions():
    """close() stops admissions but lets in-flight sessions finish with
    the bytes an undisturbed session gets; submit() afterwards raises."""
    svc = SynthesisService(tiny_pipeline(), **SERVICE)
    want = np.concatenate(list(svc.submit("abcde")))
    it = svc.submit("abcde")
    closer = threading.Thread(target=svc.close)
    closer.start()
    got = np.concatenate(list(it))
    closer.join(60)
    assert not closer.is_alive()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit("more")


def test_service_survives_scheduler_step_failure():
    """An exception out of the co-batched step reaches the in-flight
    session's consumer, and the service keeps serving."""
    svc = SynthesisService(tiny_pipeline(), **SERVICE)
    try:
        want = np.concatenate(list(svc.submit("abcde")))
        real_step = svc.server.step

        def bad_step():
            raise RuntimeError("injected device failure")

        # the scheduler is idle (blocked on its queue): the patch is in
        # place before the next session's first step
        svc.server.step = bad_step
        with pytest.raises(RuntimeError, match="injected device failure"):
            list(svc.submit("abcde"))
        svc.server.step = real_step
        got = np.concatenate(list(svc.submit("abcde")))
        np.testing.assert_array_equal(got, want)
    finally:
        svc.close()


def test_service_oneshot_with_mesh_matches_without():
    """Multi-device serving from the daemon: a service over a pipeline
    whose vocoder shards its fold rows over a mesh (as ``serve --mesh``
    wires it) gives the one-shot and streamed audio of the meshless
    service, sample for sample."""
    def run(**kw):
        svc = SynthesisService(tiny_pipeline(**kw), **SERVICE)
        try:
            return [np.concatenate(list(svc.submit("abcde", stream=s)))
                    for s in (False, True)]
        finally:
            svc.close()

    want = run()
    got = run(mesh=make_mesh(devices=["cpu"] * 2))
    for g, w in zip(got, want):
        assert len(w) > 1000
        np.testing.assert_array_equal(g, w)


def test_int16_service_stream_matches_oneshot_bytes():
    """An int16 pipeline serves PCM faded and quantized on the device end
    to end: /stream's chunked payload equals /synthesize's byte for byte
    (deterministic decode)."""
    service, httpd = serving(tiny_pipeline(output_dtype="int16"))
    try:
        port = httpd.server_address[1]
        code, _, oneshot = _post(port, "/synthesize", {"text": "abcde"})
        assert code == 200
        code, _, streamed = _post(port, "/stream", {"text": "abcde"})
        assert code == 200
        a = np.frombuffer(oneshot[44:], "<i2")
        b = np.frombuffer(streamed[44:], "<i2")
        assert len(a) > 1000 and np.abs(a.astype(np.int32)).max() > 0
        np.testing.assert_array_equal(b, a)
    finally:
        stop(service, httpd)
