"""The decode kernel's quality against the float32 scan decoder, on one
model and one mel (ports ``tools/kernel_quality.py``).

    python -m wavernn_tpu_torch.tools.kernel_quality [--steps 3000]
        [--batch_size 32] [--mode MOL|RAW] [--eval_frames 1200] [--seeds 5]
        [--lr_mult X] [--weights PATH [--eval_mel PATH]] [--hp_file PATH]
        [--device cuda|cpu]

Without ``--weights`` it trains the WaveRNN of ``--hp_file`` (default
``hparams.py``, at ``--mode``) through ``training/wavernn.py::
make_train_step`` on ``--device``, ``--steps`` steps to overfit 90 s of a
harmonic tone (``train_golden.harmonic_signal`` and its batch sampler),
at ``hp.voc_lr`` times ``--lr_mult`` (4 for RAW, 1 for MOL by default).
``--weights`` replaces the training with a checkpoint (the golden MOL:
``bench_assets/wavernn_mol_golden.msgpack``); ``--eval_mel`` replaces the
tone's mel (``bench_assets/golden_eval_mel.npy``).  The first
``--eval_frames`` frames are then copy-synthesized (fold target and
overlap from the hp file, ``fold_bucket=16``) by four decoders:

* ``scan``: the float32 scan decoder;
* ``bf16``: the decode kernel with bf16 feed-forward dots
  (``int8_ff=False``);
* ``int8_ff``: the kernel with int8 feed-forward dots, the production
  default;
* ``int8_gates``: the kernel with its five big matrices int8.

On the CPU the kernel's plain version stands in for it.  The evidence,
first the finer: (1) the deterministic mean |sample diff| of each kernel
variant to the scan (no sampling noise: the weights' precision alone), and
the scan's signal std; (2) each decoder's copy-synthesis MCD over
``--seeds`` seeds, mean and spread (the coarse gate, judged against the
scan's own spread), and the kernel's deltas.  :func:`measure` returns
those numbers; ``chip_smoke.py`` phase 41 calls it.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from wavernn_tpu_torch.tools import card, device_of, hparams, metric

# the decoders held against each other: Generator keyword arguments
VARIANTS = {
    "scan": dict(backend="scan"),
    "bf16": dict(int8_ff=False),
    "int8_ff": dict(int8_ff=True),
    "int8_gates": dict(int8_gates=True),
}
KERNEL_VARIANTS = ("bf16", "int8_ff", "int8_gates")


def measure(cfg, variables, eval_mel: np.ndarray, device, seeds: int,
            target: int, overlap: int, mu_law: bool) -> dict:
    """Each decoder of :data:`VARIANTS` on ``eval_mel``: the MCD over
    ``seeds`` seeds (``mcd_<v>_mean`` / ``_spread``; none when ``seeds``
    is 0) and the kernel's deltas, then the deterministic mean |sample
    diff| of each kernel variant to the scan (``det_absdiff_<v>``) and the
    scan's std (``det_signal_std``).  ``hp`` must be configured (the MCD's
    mel analysis)."""
    from wavernn_tpu_torch.infer.eval import copy_synthesis_mcd
    from wavernn_tpu_torch.ops.decode import Generator

    geom = dict(batched=True, target=target, overlap=overlap, mu_law=mu_law)
    out = {}
    if seeds:
        for name, kw in VARIANTS.items():
            gen = Generator(cfg, variables, device, fold_bucket=16, **kw)
            scores = [copy_synthesis_mcd(gen, eval_mel, seed=s, **geom)[0]
                      for s in range(seeds)]
            out[f"mcd_{name}_mean"] = float(np.mean(scores))
            out[f"mcd_{name}_spread"] = float(np.max(scores)
                                              - np.min(scores))
        out["mcd_delta_bf16_minus_scan"] = (out["mcd_bf16_mean"]
                                            - out["mcd_scan_mean"])
        for name in ("int8_ff", "int8_gates"):
            out[f"mcd_delta_{name}_minus_bf16"] = (out[f"mcd_{name}_mean"]
                                                   - out["mcd_bf16_mean"])
    det = {name: Generator(cfg, variables, device, fold_bucket=16,
                           deterministic=True, **kw)(eval_mel, **geom)
           for name, kw in VARIANTS.items()}
    out["det_signal_std"] = float(np.std(det["scan"]))
    for name in KERNEL_VARIANTS:
        out[f"det_absdiff_{name}"] = float(np.mean(np.abs(
            det[name] - det["scan"])))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch_size", type=int, default=32)
    # MOL synthesis has no mu-law quantization hiss, and long audio keeps
    # the per-seed MCD spread below the effects being measured
    ap.add_argument("--mode", choices=["RAW", "MOL"], default="MOL")
    ap.add_argument("--eval_frames", type=int, default=1200)
    ap.add_argument("--seeds", type=int, default=5)
    # RAW overfits fast at 4x the production lr; MOL's logistic-scale head
    # diverges there, so it trains at the production lr
    ap.add_argument("--lr_mult", type=float, default=None,
                    help="lr multiplier over hp.voc_lr (default: 4 for RAW, "
                         "1 for MOL)")
    ap.add_argument("--weights", default=None,
                    help="a checkpoint to measure in place of training one")
    ap.add_argument("--eval_mel", default=None,
                    help="a (n_mels, T) .npy mel in place of the tone's")
    ap.add_argument("--hp_file", default=None,
                    help="the model's hp file (default: hparams.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    if args.lr_mult is None:
        args.lr_mult = 4.0 if args.mode == "RAW" else 1.0

    from wavernn_tpu_torch.dsp import audio
    from wavernn_tpu_torch.models.wavernn import (
        WaveRNNConfig, to_jax_variables,
    )
    from wavernn_tpu_torch.ops import cuda_decode
    from wavernn_tpu_torch.tools import load_variables
    from wavernn_tpu_torch.tools.train_golden import harmonic_signal, train

    with hparams(args.hp_file, voc_mode=args.mode) as hp:
        cfg = WaveRNNConfig.from_hp(hp)
        rec = {"device": card(dev), "mode": args.mode,
               "eval_frames": args.eval_frames, "seeds": args.seeds}
        if args.eval_mel is None or args.weights is None:
            y = harmonic_signal(hp.sample_rate, 90.0)
            mel = audio.melspectrogram(y).astype(np.float32)
        if args.weights is not None:
            variables = load_variables(args.weights)
            rec.update(weights=str(args.weights), train_steps=0)
        else:
            labels = (audio.encode_mu_law(y, 2 ** hp.bits).astype(np.int64)
                      if args.mode == "RAW" else None)
            state, loss, secs = train(
                cfg, mel, y, labels, args.steps, args.batch_size,
                hp.voc_seq_len, hp.voc_lr * args.lr_mult,
                hp.voc_clip_grad_norm, hp.voc_pad, hp.hop_length, dev)
            variables = to_jax_variables(state.model)
            rec.update(train_steps=args.steps, final_loss=loss,
                       **{metric("train_seconds", dev): secs})
        if args.eval_mel is not None:
            mel = np.load(args.eval_mel).astype(np.float32)
        eval_mel = mel[:, :args.eval_frames]

        counts = ("launches", "launches_int8_ff", "launches_int8_gates")
        before = [getattr(cuda_decode.decode, k) for k in counts]
        t0 = time.perf_counter()
        rec.update(measure(cfg, variables, eval_mel, dev, args.seeds,
                           hp.voc_target, hp.voc_overlap, hp.mu_law))
        rec[metric("measure_seconds", dev)] = time.perf_counter() - t0
        rec["kernel_launches"] = {
            k: getattr(cuda_decode.decode, k) - b
            for k, b in zip(counts, before)}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
