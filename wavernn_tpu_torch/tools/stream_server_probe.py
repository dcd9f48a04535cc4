"""The multi-session StreamServer: parity with solo streams, then a
serving sweep over concurrent sessions (ports
``tools/stream_server_probe.py``).

    python -m wavernn_tpu_torch.tools.stream_server_probe
        [--device cuda|cpu] [--sessions 4,16] [--frames 1920]
        [--group 16] [--width 64] [--voc_weights PATH] [--hp_file FILE]
        [--target 11000] [--overlap 550]

* parity: three deterministic sessions of ``frames`` x 1/4, 1/6 and 5/16
  mel frames; each session's server output must equal its own
  ``Generator.stream`` byte for byte (max |d| is printed);
* serving: for each count in ``--sessions``, that many concurrent
  sampled sessions of ``frames`` frames (seeded uniform mels; 1920
  frames is ~24 s), after one warm-up pass: aggregate kHz (samples / wall
  s), realtime factor in all and per stream, the mean gap between a
  session's chunks, and the launches.

The vocoder defaults to the committed golden MOL at f16 in, int16 out.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from wavernn_tpu_torch.tools import (GOLDEN, card, device_of, load_variables,
                                     metric, sync_of, voc_config)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sessions", default="4,16")
    ap.add_argument("--frames", type=int, default=1920)
    ap.add_argument("--group", type=int, default=16)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--target", type=int, default=11_000)
    ap.add_argument("--overlap", type=int, default=550)
    ap.add_argument("--voc_weights", default=str(GOLDEN))
    ap.add_argument("--hp_file", default=None)
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from wavernn_tpu_torch.infer.stream_server import StreamServer
    from wavernn_tpu_torch.ops.decode import Generator

    cfg = voc_config(args.hp_file)
    variables = load_variables(args.voc_weights)
    sync = sync_of(dev)
    geom = dict(target=args.target, overlap=args.overlap,
                mu_law=cfg.mode == "RAW")
    slot_s = args.frames * cfg.hop_length / cfg.sample_rate + 1.0
    kw = dict(group=args.group, width=args.width, slot_seconds=slot_s,
              **geom)
    rng = np.random.default_rng(0)
    out = {"device": card(dev), "frames": args.frames, "group": args.group,
           "width": args.width}

    # -- parity: deterministic server == solo streams ----------------------
    det = Generator(cfg, variables, device=dev, fold_bucket=16,
                    deterministic=True, input_dtype="float16",
                    output_dtype="int16")
    mels = [rng.uniform(0, 1, (cfg.feat_dims, f)).astype(np.float32)
            for f in (args.frames // 4, args.frames // 6,
                      args.frames * 5 // 16)]
    solo = [np.concatenate(list(det.stream(m, group=args.group, **geom)))
            for m in mels]
    srv = StreamServer(det, capacity=4, **kw)
    served = srv.run(mels)
    out["parity_max_abs_diff"] = int(max(
        np.abs(g.astype(np.int32) - w.astype(np.int32)).max()
        for g, w in zip(served, solo)))
    out["parity_launches"] = srv.launches

    # -- serving sweep: concurrent sampled streams --------------------------
    gen = Generator(cfg, variables, device=dev, fold_bucket=16,
                    input_dtype="float16", output_dtype="int16")
    sweep = []
    for n_sess in (int(x) for x in args.sessions.split(",")):
        mels_n = [rng.uniform(0, 1, (cfg.feat_dims, args.frames)).astype(
            np.float32) for _ in range(n_sess)]
        StreamServer(gen, capacity=n_sess, **kw).run(mels_n)      # warm
        srv = StreamServer(gen, capacity=n_sess, seed=7, **kw)
        sync()
        t0 = time.perf_counter()
        sids = [srv.add(m) for m in mels_n]
        chunk_times = {sid: [] for sid in sids}
        n_samples = 0
        while srv.active:
            for sid, ch in srv.step().items():
                chunk_times[sid].append(time.perf_counter() - t0)
                n_samples += len(ch)
        dt = time.perf_counter() - t0
        gaps = np.concatenate([np.diff([0.0] + ts)
                               for ts in chunk_times.values() if ts])
        xrt = n_samples / cfg.sample_rate / dt
        sweep.append({
            "concurrent_sessions": n_sess,
            metric("aggregate_khz", dev): n_samples / dt / 1e3,
            metric("aggregate_xrt", dev): xrt,
            metric("per_stream_xrt", dev): xrt / n_sess,
            metric("mean_chunk_gap_ms", dev): float(np.mean(gaps)) * 1e3,
            "audio_s_total": n_samples / cfg.sample_rate,
            metric("wall_s", dev): dt,
            "launches": srv.launches,
        })
    out["sweep"] = sweep
    print(json.dumps(out))
    if out["parity_max_abs_diff"] != 0:
        raise RuntimeError("a server session differs from its solo stream")
    return out


if __name__ == "__main__":
    main()
