"""Serving wire formats, A/B: int16 PCM against mulaw8 egress, f16 against
uint8 ingress, each timed and scored (ports ``tools/wire_format_probe.py``).

    python -m wavernn_tpu_torch.tools.wire_format_probe [--device cuda|cpu]
        [--passes 7] [--runs 5] [--frames 1920] [--mcd_frames 1200]
        [--voc_weights PATH] [--hp_file FILE] [--target 11000]
        [--overlap 550]

Four arms (output wire, input wire): int16 + float16 (the serving
default), mulaw8 + float16, int16 + uint8 and mulaw8 + uint8.  Each pass
serves ``runs`` seeded uniform mels of ``frames`` frames through each arm
in turn (interleaved, so drift hits every arm alike), per utterance
prestage / submit, then prefetch and collect of all: kHz = samples / wall
s of the pass; the median and best over ``passes``, and each arm's median
against int16's.  Then the quality cost: copy-synthesis MCD of the first
``mcd_frames`` frames of the golden eval mel through each arm, its wire
bytes expanded to float on the host (what a client of that wire hears),
sampled, seed 0.  The vocoder defaults to the committed golden MOL.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from wavernn_tpu_torch.tools import (GOLDEN, REPO, card, device_of,
                                     load_variables, metric, voc_config)

ARMS = {"int16": ("int16", "float16"), "mulaw8": ("mulaw8", "float16"),
        "int16_u8in": ("int16", "uint8"), "mulaw8_u8in": ("mulaw8", "uint8")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--passes", type=int, default=7)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--frames", type=int, default=1920)
    ap.add_argument("--mcd_frames", type=int, default=1200)
    ap.add_argument("--target", type=int, default=11_000)
    ap.add_argument("--overlap", type=int, default=550)
    ap.add_argument("--voc_weights", default=str(GOLDEN))
    ap.add_argument("--hp_file", default=None)
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.dsp.audio import decode_mu_law
    from wavernn_tpu_torch.infer.eval import copy_synthesis_mcd
    from wavernn_tpu_torch.ops.decode import Generator

    cfg = voc_config(args.hp_file)
    if not hp.is_configured():
        hp.configure(REPO / "hparams.py")   # the MCD's mel analysis
    variables = load_variables(args.voc_weights)
    mu_law = cfg.mode == "RAW"
    geom = dict(target=args.target, overlap=args.overlap)
    expand = {
        "int16": lambda w: w.astype(np.float64) / 32767.0,
        "mulaw8": lambda w: decode_mu_law(w.astype(np.float64), 256,
                                          from_labels=True),
    }
    gens = {name: Generator(cfg, variables, device=dev, fold_bucket=16,
                            output_dtype=od, input_dtype=idt)
            for name, (od, idt) in ARMS.items()}
    rng = np.random.default_rng(0)
    mels = [rng.uniform(0, 1, (cfg.feat_dims, args.frames)).astype(
        np.float32) for _ in range(args.runs)]
    for gen in gens.values():                       # warm each arm
        gen(mels[0], batched=True, mu_law=mu_law, **geom)

    rates = {name: [] for name in gens}
    for p in range(args.passes):
        for name, gen in gens.items():              # interleaved arms
            t0 = time.perf_counter()
            hs = [gen.submit(gen.prestage(m, True, **geom), True,
                             mu_law=mu_law, seed=p * args.runs + s + 1,
                             **geom)
                  for s, m in enumerate(mels)]
            for h in hs:
                gen.prefetch(h)
            n = sum(len(gen.collect(h)) for h in hs)
            rates[name].append(n / (time.perf_counter() - t0) / 1e3)

    out = {"device": card(dev), "frames": args.frames, "runs": args.runs,
           "passes": args.passes}
    med = {name: float(np.median(r)) for name, r in rates.items()}
    for name, r in rates.items():
        out[metric(f"{name}_khz_median", dev)] = med[name]
        out[metric(f"{name}_khz_best", dev)] = float(max(r))
        if name != "int16":
            out[metric(f"{name}_vs_int16_pct", dev)] = 100.0 * (med[name]
                                                   / med["int16"] - 1)
    eval_mel = np.load(REPO / "bench_assets" / "golden_eval_mel.npy")[
        :, :args.mcd_frames]
    for name, gen in gens.items():
        score, _ = copy_synthesis_mcd(
            gen, eval_mel, batched=True, mu_law=mu_law, seed=0,
            to_float=expand[ARMS[name][0]], **geom)
        out[f"mcd_{name}"] = float(score)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
