"""Drive the HTTP serving daemon: real requests through the real
ThreadingHTTPServer on a loopback port (ports ``tools/http_serve_probe.py``).

    python -m wavernn_tpu_torch.tools.http_serve_probe [--device cuda|cpu]
        [--concurrent 4] [--tts_steps 400] [--tts_weights PATH]
        [--voc_weights PATH] [--hp_file FILE] [--target 11000]
        [--overlap 550]

Builds the two-stage pipeline (deterministic decode, int16 out), binds the
server on port 0 and sends: ``/health``, one ``/synthesize`` warm-up (on
the card it builds both kernels at their first launch), then
``concurrent`` concurrent ``/synthesize`` requests of distinct texts
(aggregate kHz = samples / wall s of the batch), then ``/stream`` twice:
its PCM must equal the warm-up's one-shot PCM and repeat byte for byte;
its time to the first PCM byte through HTTP is the TTFB.  The Tacotron
defaults to ``TacotronConfig()`` with seeded weights
(``init_variables(cfg, 0)``, untrained: every text runs to ``tts_steps``)
at r = 2, and the vocoder to the committed golden MOL, in folds of
``target`` + 2 x ``overlap``.  ``--tts_weights`` takes r from the
checkpoint's step and the hparams' ``tts_schedule``, as the serve CLI
does; ``--hp_file`` gives the configs of other weights.  Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time

from wavernn_tpu_torch.tools import (GOLDEN, REPO, card, device_of, metric,
                                     voc_config)


def post(port: int, path: str, text: str, timeout: float = 600):
    """(body, seconds to the first PCM byte past the WAV header, seconds
    in all) of one POST; raises on a status other than 200.  ``read1``
    returns each chunk of a chunked body as it arrives, so the first PCM
    byte is timed when its chunk lands, whatever the chunk's size."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", path, body=json.dumps({"text": text}).encode())
    resp = conn.getresponse()
    body, first = b"", None
    while True:
        blk = resp.read1(65536)
        if not blk:
            break
        body += blk
        if first is None and len(body) > 44:
            first = time.perf_counter() - t0
    total = time.perf_counter() - t0
    conn.close()
    if resp.status != 200:
        raise RuntimeError(f"{path}: {resp.status} {body[:200]!r}")
    return body, first, total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--concurrent", type=int, default=4)
    ap.add_argument("--tts_steps", type=int, default=400)
    ap.add_argument("--tts_weights", default=None,
                    help="Tacotron weights (default: seeded, untrained)")
    ap.add_argument("--voc_weights", default=str(GOLDEN))
    ap.add_argument("--target", type=int, default=11_000)
    ap.add_argument("--overlap", type=int, default=550)
    ap.add_argument("--hp_file", default=None,
                    help="hparams file with both models' configs (default: "
                         "the default configs)")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.gen_tacotron import load_weights, r_for_step
    from wavernn_tpu_torch.infer.http_server import (SynthesisService,
                                                     make_http_server)
    from wavernn_tpu_torch.infer.pipeline import TTSPipeline
    from wavernn_tpu_torch.models.tacotron import (TacotronConfig,
                                                   init_variables)
    from wavernn_tpu_torch.text.symbols import symbols
    from wavernn_tpu_torch.tools import load_variables

    voc_cfg = voc_config(args.hp_file)
    tts_cfg = (TacotronConfig.from_hp(hp, num_chars=len(symbols))
               if args.hp_file else TacotronConfig())
    if args.tts_weights:
        if not hp.is_configured():
            hp.configure(REPO / "hparams.py")
        tts_vars, step = load_weights(args.tts_weights, None, "tacotron")
        r = r_for_step(step, hp.tts_schedule)
    else:
        tts_vars, r = init_variables(tts_cfg, 0), 2
    pipe = TTSPipeline(tts_cfg, tts_vars, voc_cfg,
                       load_variables(args.voc_weights),
                       ["english_cleaners"], r=r, device=dev,
                       tts_steps=args.tts_steps, deterministic=True,
                       output_dtype="int16")
    service = SynthesisService(pipe, target=args.target,
                               overlap=args.overlap,
                               mu_law=voc_cfg.mode == "RAW", group=16,
                               capacity=max(4, args.concurrent))
    httpd = make_http_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    sr = voc_cfg.sample_rate
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
        conn.close()

        text = "the quick brown fox jumps over the lazy dog"
        warm, _, warm_s = post(port, "/synthesize", text)

        results = [None] * args.concurrent

        def run(i):
            results[i] = post(port, "/synthesize", f"{text} take {i}")

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(args.concurrent)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if any(r is None for r in results):
            raise RuntimeError("a concurrent request failed")
        samples = sum((len(r[0]) - 44) // 2 for r in results)

        streamed, ttfb, stream_s = post(port, "/stream", text)
        again, _, _ = post(port, "/stream", text)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    rec = {
        "device": card(dev),
        "health_ok": health["ok"],
        "concurrent": args.concurrent,
        "tts_steps": args.tts_steps,
        "r": r,
        metric("warmup_s", dev): warm_s,
        metric("concurrent_wall_s", dev): wall,
        metric("concurrent_khz", dev): samples / wall / 1e3,
        metric("concurrent_xrt", dev): samples / sr / wall,
        metric("latency_s", dev): [r[2] for r in results],
        metric("stream_ttfb_ms", dev): ttfb * 1e3,
        metric("stream_s", dev): stream_s,
        "stream_samples": (len(streamed) - 44) // 2,
        "stream_equals_oneshot": streamed[44:] == warm[44:],
        "stream_repeats": again[44:] == streamed[44:],
        "launches": service.server.server.launches,
    }
    print(json.dumps(rec))
    if not (rec["stream_equals_oneshot"] and rec["stream_repeats"]):
        raise RuntimeError("deterministic /stream differs from /synthesize "
                           "or from itself")
    return rec


if __name__ == "__main__":
    main()
