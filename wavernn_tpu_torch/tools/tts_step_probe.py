"""Tacotron decoder step time at B = 1, full width: the decoder-step kernel
against the plain decoder (ports ``tools/tts_step_probe.py``).

    python -m wavernn_tpu_torch.tools.tts_step_probe [frames] [K]
        [--passes 3] [--device cuda|cpu]

``TTSGenerator`` on ``TacotronConfig()`` with seeded weights
(``init_variables(cfg, 0)``), r = 2, a 60-symbol text from
``np.random.default_rng(0)``.  The model is untrained, so the stop never
fires and every call decodes ``frames`` frames.  A pass submits K decodes
back to back and collects only the last; us per decoder step is the pass
time over K times the steps per call, best of ``passes``.  The time covers
the whole submit (encoder, decode loop, postnet).  ``--device cpu`` runs
the kernel's plain version in place of the kernel.  Prints one line per
backend, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from wavernn_tpu_torch.tools import card, device_of, metric, sync_of

R = 2


def step_time(gen, seq, K: int, passes: int) -> tuple:
    """(best seconds per decoder step, steps per call)."""
    dev = gen.device
    sync = sync_of(dev)
    mel, _, _ = gen(seq, r=R)                        # warm
    n_steps = mel.shape[1] // R
    best = float("inf")
    for _ in range(passes):
        sync()
        t0 = time.perf_counter()
        handles = [gen.submit(seq, r=R) for _ in range(K)]
        gen.collect(handles[-1])
        best = min(best, (time.perf_counter() - t0) / (K * n_steps))
        for h in handles[:-1]:
            gen.collect(h)
    return best, n_steps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", type=int, nargs="?", default=3000)
    ap.add_argument("K", type=int, nargs="?", default=6)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.models.tacotron import TacotronConfig, init_variables

    cfg = TacotronConfig()
    variables = init_variables(cfg, 0)
    rng = np.random.default_rng(0)
    seq = [int(i) for i in rng.integers(1, cfg.num_chars, 60)]
    tag = card(dev)
    key = metric("us_per_step", dev)
    rec = {"device": tag, "frames": args.frames, "K": args.K, "r": R}
    for backend in ("kernel", "plain"):
        gen = TTSGenerator(cfg, variables, dev, steps=args.frames,
                           backend=backend)
        sec, n_steps = step_time(gen, seq, args.K, args.passes)
        rec[backend] = {key: sec * 1e6, "steps_per_call": n_steps}
        print(f"[{tag}] {backend:7s} decoder {sec * 1e6:9.2f} us/step "
              f"({n_steps} steps/call)", flush=True)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
