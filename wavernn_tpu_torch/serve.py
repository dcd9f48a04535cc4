"""TTS serving daemon of the PyTorch port: text -> speech over HTTP,
co-batched across requests (ports the repository's ``serve.py``).

    python -m wavernn_tpu_torch.serve [--hp_file hparams.py] [--port 8000]
        [--host 127.0.0.1] [--voc_weights ...] [--tts_weights ...]
        [--sessions 4] [--deterministic] [--device cuda|cpu]
        [--mesh [--mesh_devices cuda:0,cuda:1]]

    curl localhost:8000/health
    curl -X POST localhost:8000/synthesize -d '{"text": "hello"}' -o out.wav
    curl -X POST localhost:8000/stream -d '{"text": "hello"}' -o out.wav -N

The device defaults to ``cuda`` and is never swapped for another: without
CUDA the daemon fails to start.  ``--device cpu`` runs the kernels' plain
PyTorch versions instead, at CPU speed.  ``--mesh`` shards the vocoder's
fold rows over a device mesh (``hp.mesh_shape`` when set; every visible
CUDA device, or ``--mesh_devices``, whose first must be ``--device``'s):
each launch of the service runs one decode per shard.
"""

from __future__ import annotations

import argparse
import signal
import time

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.gen_tacotron import load_weights, r_for_step
from wavernn_tpu_torch.infer.http_server import (SynthesisService,
                                                 make_http_server)
from wavernn_tpu_torch.infer.pipeline import TTSPipeline
from wavernn_tpu_torch.models.tacotron import TacotronConfig
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.parallel.mesh import add_mesh_args, mesh_from_args
from wavernn_tpu_torch.text.symbols import symbols
from wavernn_tpu_torch.utils.display import simple_table


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="TTS HTTP serving daemon of the PyTorch port")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000,
                        help="port to bind (0: any free port)")
    parser.add_argument("--voc_weights", type=str,
                        help="[string/path] alternative WaveRNN weights")
    parser.add_argument("--tts_weights", type=str,
                        help="[string/path] alternative Tacotron weights")
    parser.add_argument("--sessions", type=int, default=4,
                        help="max concurrent vocoder sessions (further "
                             "requests queue)")
    parser.add_argument("--group", type=int, default=16,
                        help="folds per session per scheduling step")
    parser.add_argument("--slot_seconds", type=float, default=30.0,
                        help="max audio seconds per session slot")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--deterministic", action="store_true",
                        help="mode/argmax draws: reproducible audio")
    parser.add_argument("--no_warmup", action="store_true",
                        help="skip the startup warm-up synthesis (the "
                             "kernels' build is then paid by the first "
                             "requests)")
    parser.add_argument("--tts_backend", choices=["auto", "kernel", "plain"],
                        default="auto",
                        help="Tacotron decoder: the CUDA kernel (B=1) or "
                             "the plain PyTorch decoder")
    parser.add_argument("--output_dtype",
                        choices=["int16", "mulaw8", "float64"],
                        default="int16",
                        help="int16 (default): 16-bit PCM faded and "
                             "quantized on the device for both one-shot "
                             "and streamed responses; mulaw8: 8-bit mu-law "
                             "wire bytes off the device, expanded to PCM16 "
                             "on the host before WAV framing; float64: "
                             "quantized on the host (debugging)")
    parser.add_argument("--input_dtype",
                        choices=["float32", "float16", "uint8"],
                        default="float16",
                        help="wire dtype of the mels staged to the vocoder")
    add_mesh_args(parser)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--verbose", action="store_true",
                        help="log every HTTP request")
    parser.add_argument("--hp_file", metavar="FILE", default="hparams.py")
    return parser.parse_args(argv)


def setup(args: argparse.Namespace):
    """Load both models onto ``args.device``, start the synthesis service,
    bind the HTTP server and warm both decode paths (unless
    ``--no_warmup``).  Returns ``(service, httpd)``; the caller runs
    ``httpd.serve_forever()`` and closes both."""
    hp.configure(args.hp_file)
    mesh = mesh_from_args(args, hp.get("mesh_shape"))
    voc_cfg = WaveRNNConfig.from_hp(hp)
    voc_vars, voc_step = load_weights(args.voc_weights, hp.voc_model_id,
                                      "wavernn")
    tts_cfg = TacotronConfig.from_hp(hp, num_chars=len(symbols))
    tts_vars, tts_step = load_weights(args.tts_weights, hp.tts_model_id,
                                      "tacotron")
    r = r_for_step(tts_step, hp.tts_schedule)

    pipeline = TTSPipeline(
        tts_cfg, tts_vars, voc_cfg, voc_vars,
        cleaner_names=hp.tts_cleaner_names, r=r, device=args.device,
        tts_backend=args.tts_backend,
        int8_gates=bool(hp.get("gen_int8", False)),
        deterministic=args.deterministic, mesh=mesh,
        output_dtype=args.output_dtype, input_dtype=args.input_dtype)
    print("Using device:", pipeline.voc.device)
    service = SynthesisService(
        pipeline, target=hp.voc_target, overlap=hp.voc_overlap,
        mu_law=hp.mu_law and voc_cfg.mode == "RAW", group=args.group,
        capacity=args.sessions, slot_seconds=args.slot_seconds,
        seed=args.seed)
    try:
        httpd = make_http_server(service, args.host, args.port,
                                 quiet=not args.verbose)
    except OSError:
        service.close()
        raise

    if not args.no_warmup:
        # build the kernels (at their first launch) and run both decode
        # paths once before accepting traffic
        t0 = time.time()
        print("Warming up (both decode paths)...")
        for stream in (False, True):
            for _ in service.submit("warm up.", stream=stream):
                pass
        print(f"Warm-up done in {time.time() - t0:.1f} s")

    simple_table([
        ("WaveRNN", f"{voc_step // 1000}k"),
        ("Tacotron", f"{tts_step // 1000}k"),
        ("r", r),
        ("device", pipeline.voc.device),
        ("mesh", mesh.describe() if mesh is not None else "none"),
        ("tts decode", pipeline.tts.backend),
        ("output", args.output_dtype),
        ("input", args.input_dtype),
        ("sessions", args.sessions),
        ("endpoint", f"http://{args.host}:{httpd.server_address[1]}"),
    ])
    return service, httpd


def main(argv=None):
    service, httpd = setup(parse_args(argv))
    print("Serving: POST /synthesize | POST /stream | GET /health "
          "(ctrl-c or SIGTERM to stop)", flush=True)

    def _sigterm(*_):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # not shutdown(): that deadlocks once serve_forever has returned
        # on this same thread
        httpd.server_close()
        service.close()


if __name__ == "__main__":
    main()
