"""Serving-mode walkthrough: the ways to synthesize many utterances (ports
``examples/serving_demo.py``).

    python -m wavernn_tpu_torch.examples.serving_demo [--device cuda]

Beyond the reference's one-at-a-time ``generate`` (ref: gen_tacotron.py,
models/fatchord_version.py:169), the port serves requests five ways, all
on untrained tiny models (:func:`tiny_models`: a Tacotron with 32-wide
decoder and LSTMs, r = 5, from ``np.random.default_rng(0)``; a RAW 9-bit
WaveRNN with 32-wide GRUs and FC layers, from ``torch.manual_seed(0)``):

  1. ``TTSPipeline(texts)``     - both stages batched (the Tacotron's plain
     decoder batches the texts; the vocoder runs one launch for all);
  2. ``pipe.stream_synthesize`` - pipelined two-stage streaming: each
     waveform yields as soon as it is ready while later texts decode;
  3. ``tts.submit``/``voc.submit`` - raw handles for custom serving loops;
  4. a ``StreamServer`` (group 2, width 8, capacity 4) co-batching the
     three utterances' streams with deterministic decode: each session's
     audio equals its own solo ``Generator.stream``;
  5. the HTTP daemon over the same pipeline: ``POST /synthesize`` and
     ``GET /health``.

On the card sections 2, 3 and 5 run both hand-written kernels (the
Tacotron decoder step and the WaveRNN decode), sections 1 and 4 the decode
kernel.  The point is the API surface and the equality of the paths, not
audio quality.  The fold geometry is the JAX example's (``TARGET`` /
``OVERLAP``), the text -> mel decode stops at ``TTS_STEPS`` frames, and
each server's slot buffer holds ``capacity`` slots of ``SLOT_SECONDS``.
The device defaults to ``cuda`` and is never swapped for another: without
CUDA the command fails.
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time

import numpy as np
import torch

from wavernn_tpu_torch.infer.http_server import (
    SynthesisService, make_http_server,
)
from wavernn_tpu_torch.infer.pipeline import TTSPipeline
from wavernn_tpu_torch.infer.stream_server import StreamServer
from wavernn_tpu_torch.models.tacotron import TacotronConfig, init_variables
from wavernn_tpu_torch.models.wavernn import (
    WaveRNN, WaveRNNConfig, to_jax_variables,
)
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.text import text_to_sequence
from wavernn_tpu_torch.text.symbols import symbols
from wavernn_tpu_torch.tools import device_of

TEXTS = ["hello world", "three serving modes", "all equal"]
CLEANERS = ["english_cleaners"]
R = 5
SERVER = dict(group=2, width=8, capacity=4)
TARGET, OVERLAP, TTS_STEPS, SLOT_SECONDS = 2750, 550, 20, 30.0


def tiny_models(seed: int = 0):
    """(tts_cfg, tts_variables, voc_cfg, voc_variables): the JAX example's
    shapes, the weights in the flax layout."""
    tts_cfg = TacotronConfig(
        embed_dims=16, num_chars=len(symbols), encoder_dims=16,
        decoder_dims=32, n_mels=80, fft_bins=80, postnet_dims=16,
        encoder_K=3, lstm_dims=32, postnet_K=3, num_highways=2,
    )
    voc_cfg = WaveRNNConfig(
        rnn_dims=32, fc_dims=32, bits=9, pad=2, upsample_factors=(5, 5, 11),
        feat_dims=80, compute_dims=16, res_out_dims=16, res_blocks=1,
        mode="RAW",
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        voc_vars = to_jax_variables(WaveRNN(voc_cfg))
    return tts_cfg, init_variables(tts_cfg, seed), voc_cfg, voc_vars


def serve_sessions(det: Generator, mels, target: int, overlap: int,
                   slot_seconds: float = 30.0):
    """Section 4: the mels served as concurrent sessions of one
    ``StreamServer`` and each as its solo ``det.stream`` (same group);
    raises unless each session is within 1e-6 of its solo stream.  Returns
    (served, solo, the server's launches)."""
    srv = StreamServer(det, target=target, overlap=overlap, mu_law=True,
                       slot_seconds=slot_seconds, **SERVER)
    served = srv.run(mels)
    solo = [np.concatenate(list(det.stream(
        m, target=target, overlap=overlap, mu_law=True,
        group=SERVER["group"]))) for m in mels]
    for a, b in zip(served, solo):
        np.testing.assert_allclose(a, b, atol=1e-6)
    return served, solo, srv.launches


def main(argv=None) -> dict:
    """Run the five sections.  Returns their outputs: ``batched``,
    ``streamed``, ``manual``, ``mels`` (section 3's), ``served``, ``solo``,
    ``launches`` (section 4's), ``wav_bytes`` and ``health`` (section
    5's)."""
    parser = argparse.ArgumentParser(
        description="The port's serving modes on tiny models")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    dev = device_of(args.device)
    tts_cfg, tts_vars, voc_cfg, voc_vars = tiny_models()
    pipe = TTSPipeline(tts_cfg, tts_vars, voc_cfg, voc_vars,
                       cleaner_names=CLEANERS, r=R, device=dev,
                       tts_steps=TTS_STEPS)
    texts = TEXTS
    target, overlap = TARGET, OVERLAP
    kw = dict(target=target, overlap=overlap)

    # 1. batch: both stages batched across utterances
    t0 = time.time()
    batched = pipe(texts, **kw)
    print(f"batch:   {len(batched)} wavs in {time.time() - t0:.1f}s "
          f"(includes the first launches)")

    # 2. streaming: audio yields per utterance while later ones decode
    t0 = time.time()
    first = None
    streamed = []
    for w in pipe.stream_synthesize(texts, **kw):
        first = first or time.time() - t0
        streamed.append(w)
    print(f"stream:  first audio after {first:.1f}s, "
          f"all {len(streamed)} in {time.time() - t0:.1f}s")

    # 3. raw async handles: custom serving loop over both stages
    t0 = time.time()
    seqs = [text_to_sequence(t, CLEANERS) for t in texts]
    tts_handles = [pipe.tts.submit(s, r=R) for s in seqs]
    voc_handles, mels = [], []
    for i, h in enumerate(tts_handles):
        _, linear, _ = pipe.tts.collect(h)
        mel = np.clip((linear + 4) / 8, 0, 1)
        mels.append(mel)
        voc_handles.append(pipe.voc.submit(mel, True, target, overlap, True,
                                           i))
    manual = [pipe.voc.collect(h) for h in voc_handles]
    print(f"handles: {len(manual)} wavs in {time.time() - t0:.1f}s")

    # streaming and the manual loop use the same per-utterance seeds:
    # outputs are bit-identical; the batch path shares one seed per batch
    for a, b in zip(streamed, manual):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(w).all() and w.ndim == 1 for w in batched)
    print("OK: stream == manual handles; all waveforms finite")

    # 4. multi-session streaming server: concurrent utterances co-batched
    #    into shared decoder launches; with deterministic decode each
    #    session's audio equals its own solo Generator.stream
    det = Generator(voc_cfg, voc_vars, device=dev, deterministic=True)
    t0 = time.time()
    served, solo, launches = serve_sessions(det, mels, target, overlap,
                                            SLOT_SECONDS)
    print(f"server:  {len(served)} concurrent sessions in "
          f"{launches} co-batched launches, {time.time() - t0:.1f}s; "
          f"per-session audio == solo stream")

    # 5. the HTTP daemon over the same pipeline: /synthesize rides the
    #    fused one-shot fast path, /stream the co-batched scheduler
    service = SynthesisService(pipe, target=target, overlap=overlap,
                               mu_law=True, slot_seconds=SLOT_SECONDS,
                               **SERVER)
    httpd = make_http_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        t0 = time.time()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/synthesize",
                     body=json.dumps({"text": texts[0]}).encode())
        wav_bytes = conn.getresponse().read()
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert wav_bytes[:4] == b"RIFF" and len(wav_bytes) > 44
        assert health["served_sessions"] == 1
        print(f"http:    POST /synthesize -> {len(wav_bytes)} WAV bytes in "
              f"{time.time() - t0:.1f}s; health: {health}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    return {"batched": batched, "streamed": streamed, "manual": manual,
            "mels": mels, "served": served, "solo": solo,
            "launches": launches, "wav_bytes": wav_bytes, "health": health}


if __name__ == "__main__":
    main()
