"""WaveRNN vocoder CLI of the PyTorch port: copy-synthesis of a ``.npy``
mel or a ``.wav`` (ports ``gen_wavernn.py --file``).

    python -m wavernn_tpu_torch.gen_wavernn --file mel.npy \\
        --voc_weights bench_assets/wavernn_mol_golden.msgpack \\
        [--hp_file hparams.py] [--device cuda]

The device defaults to ``cuda`` and is never swapped for another: without
CUDA the command fails.  ``--device cpu`` runs the kernel's plain PyTorch
version instead, at CPU speed.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.infer.wavernn import gen_from_file, make_generator
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.utils.checkpoints import load_pytree


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate WaveRNN samples with the PyTorch port")
    parser.add_argument("--batched", "-b", dest="batched",
                        action="store_true", help="fast batched generation")
    parser.add_argument("--unbatched", "-u", dest="batched",
                        action="store_false",
                        help="slow unbatched generation")
    parser.add_argument("--target", "-t", type=int,
                        help="[int] samples in each batch index")
    parser.add_argument("--overlap", "-o", type=int,
                        help="[int] crossover samples")
    parser.add_argument("--file", "-f", type=str, required=True,
                        help="[string/path] .npy mel or .wav to vocode")
    parser.add_argument("--voc_weights", "-w", type=str,
                        help="[string/path] WaveRNN weights (.msgpack as the "
                             "JAX package writes them)")
    parser.add_argument("--output_dir", type=str,
                        help="where the WAV goes (default "
                             "model_outputs/<voc_model_id>.wavernn)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--deterministic", action="store_true",
                        help="argmax / mixture-mode decode instead of "
                             "sampling")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hp_file", metavar="FILE", default="hparams.py",
                        help="the file to use for the hyperparameters")
    parser.set_defaults(batched=None)
    args = parser.parse_args(argv)

    hp.configure(args.hp_file)
    target = hp.voc_target if args.target is None else args.target
    overlap = hp.voc_overlap if args.overlap is None else args.overlap
    batched = hp.voc_gen_batched if args.batched is None else args.batched
    model_dir = f"{hp.voc_model_id}.wavernn"
    weights = Path(args.voc_weights if args.voc_weights else
                   Path("checkpoints") / model_dir / "latest_weights.msgpack")
    out_dir = Path(args.output_dir if args.output_dir else
                   Path("model_outputs") / model_dir)

    cfg = WaveRNNConfig.from_hp(hp)
    blob = load_pytree(weights)
    variables = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    step = int(blob.get("step", 0))
    gen = make_generator(cfg, variables, args.device,
                         deterministic=args.deterministic)
    print(f"Using device: {gen.device} | weights {weights} (step {step}) | "
          f"{'batched' if batched else 'unbatched'} target {target} "
          f"overlap {overlap}")
    out = gen_from_file(gen, Path(args.file).expanduser(), out_dir, batched,
                        target, overlap, hp.mu_law, step=step,
                        seed=args.seed)
    print(f"Wrote {out}")
    return out


if __name__ == "__main__":
    main()
