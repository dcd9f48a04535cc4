"""The int8_ff adoption measurement: the decode kernel with int8 recurrent
matrices (A, ``int8_hh``) against int8 recurrent and int8 feed-forward
matrices (B, ``int8_hh`` + ``int8_ff``), per launch width.  Ports the
``--ab`` mode of ``tools/step_opt_probe.py``; its other experiments time
TPU-only variants and have no counterpart here.

    python -m wavernn_tpu_torch.tools.step_opt_probe --ab \\
        [--widths 1,4,16,48,64,132,240] [--T 2048] [--passes 5] [--reps 2] \\
        [--designs cluster,row] [--gates_widths 1,48,240] \
        [--device cuda|cpu]

Full width: the committed trained golden MOL
(``bench_assets/wavernn_mol_golden.msgpack``), sampling, the decode
kernel's cluster design (``--designs`` adds the row design, one row per
CTA, as further interleaved arms; the first design decides the crossover),
the feed-forward bounds calibrated (``ops.decode.ff_ranges``, seed 17) on
the golden eval mel's conditioning, and each width's rows cut from that
conditioning at seeded start rows.  The passes are strictly interleaved
(A, B, A, B, ...), each pass ``--reps`` back-to-back launches timed with
CUDA events, so that drift of the card's clock hits both arms alike.  Per
width it prints the median and the minimum us/step of each arm and B's
signed delta against A; then the crossover: the fewest rows from which B's
median is below A's at every measured width (none if B never wins there).
``--gates_widths`` adds, at those widths, a third interleaved arm on each
design: ``int8_gates`` (the five big matrices int8, each operand quantized
per row on the fly), which the crossover does not read.
``--device cpu`` runs the plain versions at the (small) size given, every
time labelled as a CPU host time.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from wavernn_tpu_torch.tools import (
    GOLDEN, REPO, card, device_of, load_variables, metric, sync_of,
)

WIDTHS = (1, 4, 16, 48, 64, 132, 240)


def crossover(rows: dict):
    """The fewest rows from which int8_ff's median is below int8_hh's at
    every measured width, or None.  ``rows``: width -> (A, B) medians."""
    best = None
    for width in sorted(rows, reverse=True):
        a, b = rows[width]
        if not b < a:
            break
        best = width
    return best


def _timer(dev: torch.device, reps: int):
    """ms per launch of ``fn(k)``, k < reps back to back: CUDA events on
    the card, the host clock on the CPU."""
    sync = sync_of(dev)

    def timed(fn, base: int) -> float:
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            sync()
            start.record()
            for k in range(reps):
                fn(base + k)
            end.record()
            sync()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for k in range(reps):
            fn(base + k)
        return (time.perf_counter() - t0) * 1e3 / reps
    return timed


def golden_setup(dev: torch.device, variables=None, cfg=None,
                 mel: np.ndarray = None):
    """A Generator forced to int8_ff, calibrated on ``mel``'s conditioning
    (the golden eval mel by default), and that conditioning as one packed
    stream on ``dev``.  Returns (gen, stream)."""
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
    from wavernn_tpu_torch.ops import cuda_decode
    from wavernn_tpu_torch.ops.decode import Generator

    cfg = cfg or WaveRNNConfig()
    variables = variables or load_variables(GOLDEN)
    if mel is None:
        mel = np.load(REPO / "bench_assets" / "golden_eval_mel.npy")
    gen = Generator(cfg, variables, device=dev, int8_ff=True)
    with torch.no_grad():
        m = torch.from_numpy(np.ascontiguousarray(
            mel.T[None], dtype=np.float32)).to(dev)
        mels_up, aux_mel = gen.model.upsample_parts(m)
        stream = cuda_decode.pack_stream(mels_up, aux_mel, cfg.total_scale)
        gen._calibrate_ff(stream)
    return gen, stream


def rows_of(stream: torch.Tensor, B: int, T: int, seed: int = 0):
    """(B, T, C) fold-major conditioning cut from ``stream`` at seeded
    start rows."""
    from wavernn_tpu_torch.ops import cuda_decode

    if stream.shape[0] < T:
        raise ValueError(f"the stream has {stream.shape[0]} rows, fewer "
                         f"than T={T}")
    starts = np.random.default_rng(seed).integers(
        0, stream.shape[0] - T + 1, B)
    return cuda_decode.fold_major_cond(
        stream, torch.from_numpy(starts).to(stream.device), T)


def ab_int8_ff(gen, stream: torch.Tensor, widths, T: int, passes: int,
               reps: int, log=print, designs=("cluster",),
               gates_widths=()) -> dict:
    """Interleaved A/B passes per width, for each kernel design in
    ``designs`` (``cuda_decode.decode``'s; the first one's arms decide the
    crossover), with an ``int8_gates`` arm at the widths in
    ``gates_widths``; returns the JSON record: per width the first
    design's arms at the top and every design's under ``"designs"``."""
    from wavernn_tpu_torch.ops import cuda_decode

    dev = stream.device
    tag = card(dev)
    med, mn = (metric(f"{k}_us_per_step", dev) for k in ("median", "min"))
    timed = _timer(dev, reps)
    c = gen.cfg
    variants = {"int8_hh": gen.packed, "int8_hh+int8_ff": gen.packed_ff}
    packs = dict(variants)
    if gates_widths:
        packs["int8_gates"] = cuda_decode.pack_weights(
            gen.weights, c.feat_dims, c.aux_dims, int8_gates=True)
    rec = {"device": tag, "T": T, "passes": passes, "reps": reps,
           "designs": list(designs),
           "ff_scales": [float(x) for x in gen.ff_scales.cpu()],
           "widths": []}
    medians = {}
    for B in widths:
        cond = rows_of(stream, B, T)
        names = list(variants) + (["int8_gates"] if B in gates_widths
                                  else [])
        arms = [(d, name) for d in designs for name in names]
        for d, name in arms:    # warm every arm
            cuda_decode.decode(packs[name], cond, min(T, 64), 0, c.mode,
                               c.n_classes, False, design=d)
        times = {arm: [] for arm in arms}
        for i in range(passes):
            for j, (d, name) in enumerate(arms):
                ms = timed(lambda s: cuda_decode.decode(
                    packs[name], cond, T, s, c.mode, c.n_classes, False,
                    design=d), (len(arms) * i + j) * reps + 1)
                times[(d, name)].append(ms * 1e3 / T)
        row = {"rows": B, "designs": {}}
        for d in designs:
            a, b = (float(np.median(times[(d, n)])) for n in variants)
            am, bm = (float(np.min(times[(d, n)])) for n in variants)
            row["designs"][d] = {
                "int8_hh": {med: a, mn: am}, "int8_ff": {med: b, mn: bm},
                "delta_median": (b - a) / a, "delta_min": (bm - am) / am}
            gates = ""
            if "int8_gates" in names:
                g, gm = (f(times[(d, "int8_gates")])
                         for f in (np.median, np.min))
                row["designs"][d]["int8_gates"] = {med: float(g),
                                                   mn: float(gm)}
                gates = f", int8_gates {g:8.2f} / {gm:8.2f}"
            if d == designs[0]:
                medians[B] = (a, b)
                row.update(row["designs"][d])
            log(f"[{tag}] {d} design, rows {B:4d} x {T}: int8_hh {a:8.2f} / "
                f"{am:8.2f} us/step (median / min), +int8_ff {b:8.2f} / "
                f"{bm:8.2f}: delta median {100 * (b - a) / a:+6.2f}%, min "
                f"{100 * (bm - am) / am:+6.2f}%{gates}")
        rec["widths"].append(row)
        del cond
    rec["crossover_rows"] = crossover(medians)
    log(f"[{tag}] int8_ff crossover on the {designs[0]} design (fewest rows "
        f"from which it wins at every measured width): "
        f"{rec['crossover_rows']}")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", action="store_true",
                    help="the int8_ff A/B, the only mode (the reference's "
                         "flag, accepted and implied)")
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    ap.add_argument("--T", type=int, default=2048)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--reps", type=int, default=2,
                    help="back-to-back launches per timed pass")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--designs", default="cluster",
                    help="the kernel designs to time, comma-separated "
                         "(cluster, row); the first decides the crossover")
    ap.add_argument("--gates_widths", default="",
                    help="widths at which to add an int8_gates arm, "
                         "comma-separated (default: none)")
    ap.add_argument("--voc_weights", default=None,
                    help="msgpack weights (default: the golden MOL)")
    ap.add_argument("--hp_file", default=None,
                    help="hparams of --voc_weights (default: the golden's)")
    ap.add_argument("--mel", default=None,
                    help="(n_mels, frames) .npy mel to calibrate on and cut "
                         "rows from (default: the golden eval mel)")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    from wavernn_tpu_torch import set_float32_policy
    from wavernn_tpu_torch.tools import voc_config

    set_float32_policy()
    widths = [int(w) for w in args.widths.split(",")]
    variables = load_variables(args.voc_weights) if args.voc_weights else None
    mel = np.load(args.mel) if args.mel else None
    with torch.no_grad():
        gen, stream = golden_setup(dev, variables, voc_config(args.hp_file),
                                   mel)
        rec = ab_int8_ff(gen, stream, widths, args.T, args.passes,
                         args.reps, designs=tuple(args.designs.split(",")),
                         gates_widths=[int(w) for w in
                                       args.gates_widths.split(",") if w])
    print(f"card: {rec['device']}")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
