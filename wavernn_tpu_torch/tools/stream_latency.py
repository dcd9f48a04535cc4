"""Streaming latency and the stream's parity with its one-shot oracle
(ports ``tools/stream_latency.py``).

    python -m wavernn_tpu_torch.tools.stream_latency [--device cuda|cpu]
        [--frames 1920] [--group 16] [--reps 3] [--voc_weights PATH]
        [--hp_file FILE] [--target 11000] [--overlap 550]

For one seeded uniform mel of ``frames`` frames (1920 is ~24 s) through
``Generator.stream``:

* parity: with deterministic decode the concatenated stream must equal
  ``stream_oneshot`` (the same launches finalized in one piece) sample
  for sample, float64 out;
* latency: time to the first chunk on the host (``ttfc_ms``, from the
  ``stream`` call, the conditioning build included) and the whole
  stream's rate (``stream_khz``), sampled decode, median of ``reps``
  after one warm-up stream; float64 out, then int16 out at ``group``, at
  group 32 and at group 32 with a first group of 4 folds.

The vocoder defaults to the committed golden MOL at f16 in.  Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from wavernn_tpu_torch.tools import (GOLDEN, card, device_of, load_variables,
                                     metric, sync_of, voc_config)


def latency(gen, mel, reps: int, sync, **kw):
    """(median ttfc s, median stream s, samples) over ``reps`` streams
    after one warm-up."""
    for _ in gen.stream(mel, **kw):
        pass
    ttfc, total, n = [], [], 0
    for p in range(reps):
        sync()
        t0 = time.perf_counter()
        first, n = None, 0
        for ch in gen.stream(mel, seed=p, **kw):
            if first is None:
                first = time.perf_counter() - t0
            n += len(ch)
        total.append(time.perf_counter() - t0)
        ttfc.append(first)
    return float(np.median(ttfc)), float(np.median(total)), n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=1920)
    ap.add_argument("--group", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--target", type=int, default=11_000)
    ap.add_argument("--overlap", type=int, default=550)
    ap.add_argument("--voc_weights", default=str(GOLDEN))
    ap.add_argument("--hp_file", default=None)
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from wavernn_tpu_torch.ops.decode import Generator

    cfg = voc_config(args.hp_file)
    variables = load_variables(args.voc_weights)
    sync = sync_of(dev)
    geom = dict(target=args.target, overlap=args.overlap,
                mu_law=cfg.mode == "RAW")
    mel = np.random.default_rng(0).uniform(
        0, 1, (cfg.feat_dims, args.frames)).astype(np.float32)

    def make(**kw):
        return Generator(cfg, variables, device=dev, fold_bucket=16,
                         input_dtype="float16", **kw)

    det = make(deterministic=True)
    streamed = np.concatenate(list(det.stream(mel, group=args.group,
                                              **geom)))
    oneshot = det.stream_oneshot(mel, group=args.group, **geom)
    out = {"device": card(dev), "frames": args.frames,
           "parity_max_abs_diff": float(np.abs(streamed - oneshot).max()),
           "first_chunk_audio_s": (args.group * (args.target + args.overlap)
                                   / cfg.sample_rate)}
    arms = (("float64", make(), args.group, None),
            ("int16", make(output_dtype="int16"), args.group, None),
            ("int16_g32", make(output_dtype="int16"), 32, None),
            ("int16_g32_ramp4", make(output_dtype="int16"), 32, 4))
    for tag, gen, group, first_group in arms:
        ttfc, dt, n = latency(gen, mel, args.reps, sync, group=group,
                              first_group=first_group, **geom)
        prefix = "" if tag == "float64" else f"{tag}_"
        out[metric(f"{prefix}ttfc_ms", dev)] = ttfc * 1e3
        out[metric(f"{prefix}stream_khz", dev)] = n / dt / 1e3
        out[metric(f"{prefix}stream_xrt", dev)] = n / cfg.sample_rate / dt
    out["audio_s"] = n / cfg.sample_rate
    print(json.dumps(out))
    if out["parity_max_abs_diff"] != 0:
        raise RuntimeError("the stream differs from stream_oneshot")
    return out


if __name__ == "__main__":
    main()
