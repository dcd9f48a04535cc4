"""Decode-kernel cost breakdown: time the decode kernel's variants and its
matmul floor to see where a step's microseconds go (the weight-streaming
dots, the gate math, sampling, the conditioning read, the output write).
Ports ``tools/kernel_breakdown.py``.

    python -m wavernn_tpu_torch.tools.kernel_breakdown [B] [T] \\
        [--device cuda|cpu] [--reps K] [--trace DIR]

Defaults: B = 64 rows, T = 12,160 steps.  It runs

* the matmul floor (``ops/matmul_floor.py``: six bf16 dots of a (B, 512)
  state per step, from a seeded nonzero state);
* the full decode kernel of the row design (``csrc/decode.cu``, the one
  the ablations are built in; the cluster design is timed beside it by
  ``chip_smoke.py`` phases 3 and 28): MOL sampling, int8 recurrent
  matrices, the production rows per CTA, on the committed trained golden
  (``bench_assets/wavernn_mol_golden.msgpack``) over a seeded uniform bf16
  conditioning (B, T, 208), so that gates and sampling see trained
  activations;
* int8_hh off, deterministic, the five ablations, the other rows per CTA
  (1 or 2).

On the card each variant is timed with CUDA events over K back-to-back
launches after a short warm-up, best of 2 passes; the ablated variants
launch the kernel.  ``--device cpu`` runs the plain versions at the given
(small) B and T and labels every line ``cpu``.  The last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from wavernn_tpu_torch.ops.cuda_decode import ROWS_PER_CTA
from wavernn_tpu_torch.tools import GOLDEN, card, device_of, load_variables, metric

FULL = f"full kernel (MOL sampling, int8_hh, R={ROWS_PER_CTA})"
OTHER_R = 3 - ROWS_PER_CTA    # the other rows per CTA the kernel is built for
VARIANTS = (
    (FULL, {}),
    ("int8_hh off (bf16 w_hh)", {"int8_hh": False}),
    ("deterministic", {"deterministic": True}),
    ("ablate sample", {"ablate": frozenset({"sample"})}),
    ("ablate gates", {"ablate": frozenset({"gates"})}),
    ("ablate sample+gates", {"ablate": frozenset({"sample", "gates"})}),
    ("ablate cond_read", {"ablate": frozenset({"cond_read"})}),
    ("ablate out_write", {"ablate": frozenset({"out_write"})}),
    (f"rows_per_cta={OTHER_R}", {"rows_per_cta": OTHER_R}),
)
WARM_T = 256     # steps of the warm-up launch


def _timer(dev: torch.device, reps: int):
    """A function that times ``fn(k)`` for k < reps, best of 2 passes:
    CUDA events on the card, the host clock on the CPU.  Returns ms per
    call."""
    def timed(fn):
        best = math.inf
        for p in range(2):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(dev)
                start.record()
                for k in range(reps):
                    fn(p * reps + k + 1)
                end.record()
                torch.cuda.synchronize(dev)
                ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                for k in range(reps):
                    fn(p * reps + k + 1)
                ms = (time.perf_counter() - t0) * 1e3
            best = min(best, ms / reps)
        return best
    return timed


def decode_inputs(B: int, T: int, dev: torch.device, seed: int = 0):
    """The golden model's packed weights (int8_hh on and off) and a seeded
    uniform(-1, 1) bf16 conditioning (B, T, C)."""
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig, from_jax_variables
    from wavernn_tpu_torch.ops import cuda_decode
    from wavernn_tpu_torch.ops.decode import extract_decode_weights

    cfg = WaveRNNConfig()
    model = from_jax_variables(load_variables(GOLDEN), cfg, dev)
    w = extract_decode_weights(model)
    packed = {q: cuda_decode.pack_weights(w, cfg.feat_dims, cfg.aux_dims,
                                          int8_hh=q) for q in (True, False)}
    C = cfg.feat_dims + cfg.res_out_dims
    rng = np.random.default_rng(seed)
    u = rng.random((B, T, C), dtype=np.float32) * 2.0 - 1.0
    cond = torch.from_numpy(u).to(torch.bfloat16).to(dev)
    return cfg, packed, cond


def run_breakdown(B: int, T: int, dev: torch.device, reps: int = 3,
                  log=print) -> dict:
    """Time the floor and every variant; ``log`` gets one line each.
    Returns the JSON record (times in ms per launch and us per step)."""
    from wavernn_tpu_torch.ops import cuda_decode
    from wavernn_tpu_torch.ops import matmul_floor as mf

    tag = card(dev)
    timed = _timer(dev, reps)
    us = metric("us_per_step", dev)
    ms = metric("ms_per_launch", dev)
    rec = {"device": tag, "B": B, "T": T, "reps": reps}

    # the matmul floor, from a seeded nonzero state
    fw = mf.make_floor_weights(0, device=dev)
    h0 = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (B, mf.H_FLOOR)).astype(np.float32)).to(dev)
    mf.matmul_floor(fw, B, min(T, WARM_T), h0)
    floor_ms = timed(lambda k: mf.matmul_floor(fw, B, T, h0))
    rec["floor"] = {ms: floor_ms, us: floor_ms * 1e3 / T}
    log(f"[{tag}] matmul floor (B={B}, H={mf.H_FLOOR}, 6 bf16 dots, "
        f"7168 columns/step): {floor_ms:.3f} ms/launch = "
        f"{floor_ms * 1e3 / T:.2f} us/step")

    cfg, packed, cond = decode_inputs(B, T, dev)
    rec["variants"] = []
    full_us = None
    for name, kw in VARIANTS:
        kw = dict(kw)
        p = packed[kw.pop("int8_hh", True)]
        det = kw.pop("deterministic", False)

        def fn(seed, steps=T):
            return cuda_decode.decode(p, cond, steps, seed, cfg.mode,
                                      cfg.n_classes, det, design="row", **kw)
        fn(0, min(T, WARM_T))
        t = timed(fn)
        per = t * 1e3 / T
        full_us = per if full_us is None else full_us
        rec["variants"].append({"name": name, ms: t, us: per,
                                "share_of_full": per / full_us})
        log(f"[{tag}] {name:40s} {t:10.3f} ms/launch = {per:8.2f} us/step "
            f"({per / full_us * 100:5.1f}% of full)")
    rec["floor_share_of_full"] = rec["floor"][us] / full_us
    log(f"[{tag}] matmul-floor share of the full kernel: "
        f"{rec['floor_share_of_full'] * 100:.1f}%")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", type=int, nargs="?", default=64)
    ap.add_argument("T", type=int, nargs="?", default=12160)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3,
                    help="back-to-back launches per timed pass")
    ap.add_argument("--trace", default=None,
                    help="write a torch.profiler chrome trace to this dir")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    from wavernn_tpu_torch import set_float32_policy
    from wavernn_tpu_torch.utils.profiling import trace

    set_float32_policy()
    with torch.no_grad(), trace(args.trace):
        rec = run_breakdown(args.B, args.T, dev, args.reps)
    print(f"card: {rec['device']}")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
