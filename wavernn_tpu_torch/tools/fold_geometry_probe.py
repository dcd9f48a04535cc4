"""Fold-geometry probe: the mel -> wav path's speed as a function of the
fold target for a fixed utterance (ports ``tools/fold_geometry_probe.py``).

The fold target trades serial decode steps against kernel rows: steps per
launch = target + 2 * overlap, rows = ceil(samples / target) padded to the
fold bucket (16).  This measures the real end-to-end curve through
``Generator`` (f16 mel in, int16 PCM out, the main path's formats), so the
``voc_target`` default can be decided on the card.

    python -m wavernn_tpu_torch.tools.fold_geometry_probe [--device cuda|cpu]
        [--frames 1920] [--targets 16500,11000,8250,5500] [--overlap 550]
        [--reps 3] [--utts 3] [--voc_weights PATH] [--hp_file FILE]

Each pass submits ``utts`` requests of one seeded uniform mel, prefetches
them and collects them all; the host clock stops after
``torch.cuda.synchronize()``.  The median pass over ``reps`` gives ms per
utterance and kHz (samples / wall-clock s).  One warm-up request precedes
the first target.  The weights default to the committed golden at the
default config; ``--hp_file`` takes the config of other weights (as the
vocoder CLI does).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from wavernn_tpu_torch.tools import (GOLDEN, card, device_of, load_variables,
                                     metric, sync_of, voc_config)


def probe(gen, mel: np.ndarray, targets, overlap: int, reps: int,
          utts: int) -> list:
    dev = gen.device
    sync = sync_of(dev)
    ms_key, khz_key = metric("ms_per_utt", dev), metric("khz", dev)
    gen(mel, batched=True, target=targets[0], overlap=overlap, mu_law=False)
    sync()
    results = []
    for target in targets:
        staged = gen.prestage(mel, batched=True, target=target,
                              overlap=overlap)
        times, total = [], 0
        for r in range(reps):
            sync()
            t0 = time.perf_counter()
            handles = [gen.submit(staged, batched=True, target=target,
                                  overlap=overlap, mu_law=False,
                                  seed=r * utts + s + 2)
                       for s in range(utts)]
            for h in handles:
                gen.prefetch(h)
            total = sum(len(gen.collect(h)) for h in handles)
            sync()
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        results.append({
            "target": target,
            "folds": staged.num_folds,
            "rows": gen._pad_folds(staged.num_folds),
            "steps_per_launch": target + 2 * overlap,
            ms_key: dt / utts * 1e3,
            khz_key: total / dt / 1e3,
        })
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=1920)
    ap.add_argument("--targets", default="16500,11000,8250,5500")
    ap.add_argument("--overlap", type=int, default=550)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--utts", type=int, default=3,
                    help="requests submitted per timed pass")
    ap.add_argument("--voc_weights", default=str(GOLDEN))
    ap.add_argument("--hp_file", default=None,
                    help="hparams file with the weights' voc_* config "
                         "(default: the default config)")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from wavernn_tpu_torch.ops.decode import Generator

    cfg = voc_config(args.hp_file)
    gen = Generator(cfg, load_variables(args.voc_weights), device=dev,
                    fold_bucket=16, input_dtype="float16",
                    output_dtype="int16")
    mel = np.random.default_rng(0).uniform(
        0, 1, (cfg.feat_dims, args.frames)).astype(np.float32)
    targets = [int(t) for t in args.targets.split(",")]
    results = probe(gen, mel, targets, args.overlap, args.reps, args.utts)
    rec = {"device": card(dev), "T_mel": args.frames,
           "overlap": args.overlap, "reps": args.reps, "utts": args.utts,
           "results": results}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
