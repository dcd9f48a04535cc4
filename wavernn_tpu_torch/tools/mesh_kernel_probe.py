"""The decode kernel under a device mesh (ports
``tools/mesh_kernel_probe.py``): ``Generator(mesh=)`` with the kernel at
full size, held byte for byte against the meshless Generator.

    python -m wavernn_tpu_torch.tools.mesh_kernel_probe [--device cuda|cpu]
        [--shards 2] [--frames 1920] [--target 11000] [--overlap 550]
        [--voc_weights PATH] [--hp_file FILE]

The mesh is ``--shards`` shards dealt over the visible CUDA devices in
turn (two shards on a one-card machine share ``cuda:0``; ``--device cpu``
puts every shard on the CPU).  Two checks:

1. the kernel itself: one request's fold-major conditioning decoded in
   one launch and through ``parallel.mesh.shard_rows`` (one launch per
   shard, each with its ``row0``), sampling: the largest |d|, which must
   be 0;
2. the composition users call: one seeded 1920-frame request through
   ``Generator(mesh=)`` and the meshless ``Generator`` (f16 in, int16 out,
   sampling and deterministic): byte-equal, with one decode launch per
   shard, and each one's kHz (samples / wall-clock s, the card
   synchronized), beside the card's name and power limit.

Exits non-zero if a check fails; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from wavernn_tpu_torch.tools import (GOLDEN, card, device_of, load_variables,
                                     metric, sync_of, voc_config)


def mesh_devices(dev: torch.device, shards: int) -> list:
    """``shards`` shards dealt over the visible CUDA devices in turn, or
    all on the CPU."""
    if dev.type == "cpu":
        return ["cpu"] * shards
    return [f"cuda:{k % torch.cuda.device_count()}" for k in range(shards)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--frames", type=int, default=1920)
    ap.add_argument("--target", type=int, default=11_000)
    ap.add_argument("--overlap", type=int, default=550)
    ap.add_argument("--voc_weights", default=str(GOLDEN))
    ap.add_argument("--hp_file", default=None,
                    help="hparams file with the weights' voc_* config "
                         "(default: the default config)")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from wavernn_tpu_torch.ops import cuda_decode
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.parallel.mesh import make_mesh, shard_rows

    plan = make_mesh(devices=mesh_devices(dev, args.shards))
    cfg = voc_config(args.hp_file)
    variables = load_variables(args.voc_weights)
    mel = np.random.default_rng(0).uniform(
        0, 1, (cfg.feat_dims, args.frames)).astype(np.float32)
    geom = dict(batched=True, target=args.target, overlap=args.overlap)
    sync = sync_of(dev)
    rec = {"device": card(dev), "mesh": plan.describe(),
           "shards": plan.n_data, "frames": args.frames}
    failures = []

    # 1. the kernel: one launch against one launch per shard
    kw = dict(fold_bucket=16, input_dtype="float16", output_dtype="int16")
    gen = Generator(cfg, variables, plan.device, mesh=plan, **kw)
    cond, T = gen.fold_conditioning(gen.prestage(mel, **geom))
    decode = lambda c, row0: cuda_decode.decode(
        gen._on(gen.packed, c.device), c, T, 5, cfg.mode, cfg.n_classes,
        False, row0=row0)
    with torch.no_grad():
        whole = decode(cond, 0)
        sharded = shard_rows(plan, decode, cond)
    rec["rows"], rec["steps"] = cond.shape[0], T
    rec["kernel_shard_max_abs_diff"] = float((whole - sharded).abs().max())
    if rec["kernel_shard_max_abs_diff"] != 0.0:
        failures.append("sharded decode differs from one launch")

    # 2. Generator(mesh=) against the meshless Generator
    khz = metric("khz", dev)
    for det in (False, True):
        mode = "deterministic" if det else "sampling"
        out = {}
        for name, mesh in (("mesh", plan), ("meshless", None)):
            g = Generator(cfg, variables, plan.device, mesh=mesh,
                          deterministic=det, **kw)
            g(mel, mu_law=False, seed=3, **geom)          # warm
            sync()
            n0 = cuda_decode.decode.launches
            t0 = time.perf_counter()
            wav = g(mel, mu_law=False, seed=3, **geom)
            sync()
            secs = time.perf_counter() - t0
            out[name] = wav
            rec[f"{name}_{mode}_{khz}"] = len(wav) / secs / 1e3
            if dev.type == "cuda":
                rec[f"{name}_launches"] = cuda_decode.decode.launches - n0
        equal = bool(np.array_equal(out["mesh"], out["meshless"]))
        rec[f"byte_equal_{mode}"] = equal
        if not equal:
            failures.append(f"mesh output differs from meshless ({mode})")
    if dev.type == "cuda" and rec["mesh_launches"] != plan.n_data:
        failures.append(f"{rec['mesh_launches']} decode launches for "
                        f"{plan.n_data} shards")
    rec["ok"] = not failures
    print(json.dumps(rec))
    if failures:
        raise SystemExit("mesh_kernel_probe: " + "; ".join(failures))
    return rec


if __name__ == "__main__":
    main()
