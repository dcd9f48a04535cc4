"""WaveRNN vocoder CLI of the PyTorch port (ports ``gen_wavernn.py``):
copy-synthesis of a ``.npy`` mel or a ``.wav``, of the held-out test set,
or the test set's copy-synthesis MCD.

    python -m wavernn_tpu_torch.gen_wavernn --file mel.npy \\
        --voc_weights bench_assets/wavernn_mol_golden.msgpack \\
        [--hp_file hparams.py] [--device cuda]
    python -m wavernn_tpu_torch.gen_wavernn [--samples N] [--gta] [--eval] \\
        [--hp_file hparams.py]
    python -m wavernn_tpu_torch.gen_wavernn --file mel.npy --mesh \\
        [--mesh_devices cuda:0,cuda:1]
    python -m wavernn_tpu_torch.gen_wavernn --file mel.npy --int8

Without ``--file`` the first ``--samples`` utterances of the test split of
``data_path`` are vocoded beside their targets into
``model_outputs/<voc_model_id>.wavernn/`` (from the GTA mels with
``--gta``), or, with ``--eval``, scored by copy-synthesis MCD.  The
weights default to the latest checkpoint of ``checkpoints/
<voc_model_id>.wavernn/``.  The device defaults to ``cuda`` and is never
swapped for another: without CUDA the command fails.  ``--device cpu`` runs
the kernel's plain PyTorch version instead, at CPU speed.  ``--mesh``
splits each launch's fold rows over a device mesh (``hp.mesh_shape`` when
set): every visible CUDA device, or ``--mesh_devices``, whose first must
be ``--device``'s.  ``--int8`` / ``--no_int8`` set ``hp.gen_int8``, the
decode kernel's ``int8_gates`` variant (off unless the hp file or
``--int8`` turns it on).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.data.dataset import get_vocoder_datasets
from wavernn_tpu_torch.infer.eval import eval_testset_mcd
from wavernn_tpu_torch.infer.wavernn import (
    gen_from_file, gen_testset, make_generator,
)
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig, from_jax_variables
from wavernn_tpu_torch.parallel.distributed import rank_device
from wavernn_tpu_torch.parallel.mesh import add_mesh_args, mesh_from_args
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.training.state import TrainState
from wavernn_tpu_torch.utils.checkpoints import load_pytree


def int8_overrides(args) -> dict:
    """``hp.configure`` overrides of ``--int8`` / ``--no_int8``."""
    return ({"gen_int8": False} if args.no_int8
            else {"gen_int8": True} if args.int8 else {})


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
    parser.add_argument("--samples", "-s", type=int,
                        help="[int] number of test-set utterances to "
                             "generate")
    parser.add_argument("--file", "-f", type=str,
                        help="[string/path] .npy mel or .wav to vocode "
                             "(default: the test set)")
    parser.add_argument("--voc_weights", "-w", type=str,
                        help="[string/path] WaveRNN weights (.msgpack as the "
                             "JAX package writes them)")
    parser.add_argument("--gta", "-g", action="store_true",
                        help="generate from the GTA test set")
    parser.add_argument("--eval", dest="eval_mcd", action="store_true",
                        help="report copy-synthesis MCD over the test set")
    parser.add_argument("--output_dir", type=str,
                        help="where the WAVs go (default "
                             "model_outputs/<voc_model_id>.wavernn)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--deterministic", action="store_true",
                        help="argmax / mixture-mode decode instead of "
                             "sampling")
    parser.add_argument("--seed", type=int, default=0)
    add_mesh_args(parser)
    int8_group = parser.add_mutually_exclusive_group()
    int8_group.add_argument("--int8", action="store_true",
                            help="int8 gate weights in the decode kernel "
                                 "(int8_gates; sets hp.gen_int8)")
    int8_group.add_argument("--no_int8", action="store_true",
                            help="no int8 gate weights (overrides "
                                 "hp.gen_int8)")
    parser.add_argument("--hp_file", metavar="FILE", default="hparams.py",
                        help="the file to use for the hyperparameters")
    parser.set_defaults(batched=None)
    args = parser.parse_args(argv)

    hp.configure(args.hp_file, **int8_overrides(args))
    target = hp.voc_target if args.target is None else args.target
    overlap = hp.voc_overlap if args.overlap is None else args.overlap
    batched = hp.voc_gen_batched if args.batched is None else args.batched
    model_dir = f"{hp.voc_model_id}.wavernn"
    weights = Path(args.voc_weights if args.voc_weights else
                   Path("checkpoints") / model_dir / "latest_weights.msgpack")
    out_dir = Path(args.output_dir if args.output_dir else
                   Path("model_outputs") / model_dir)

    samples = hp.voc_gen_at_checkpoint if args.samples is None else args.samples

    cfg = WaveRNNConfig.from_hp(hp)
    blob = load_pytree(weights)
    variables = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    step = int(blob.get("step", 0))
    mesh = mesh_from_args(args, hp.get("mesh_shape"))
    if mesh is not None and args.eval_mcd:
        raise ValueError("--mesh shards generation; --eval scores the "
                         "test set on --device alone")
    if not args.file:
        rank_device(args.device)
        paths = Paths(hp.data_path, hp.voc_model_id, hp.tts_model_id)
        _, test_set = get_vocoder_datasets(paths.data, 1, args.gta)
        print(f"Using device: {args.device} | weights {weights} (step "
              f"{step}) | {'GTA ' if args.gta else ''}test set, {samples} "
              f"utterances | {'batched' if batched else 'unbatched'} target "
              f"{target} overlap {overlap}")
        if args.eval_mcd:
            return eval_testset_mcd(cfg, variables, test_set, samples,
                                    batched, target, overlap, args.device)
        state = TrainState(model=from_jax_variables(variables, cfg,
                                                    args.device),
                           opt_state=None, step=step)
        return gen_testset(cfg, state, test_set, samples, batched, target,
                           overlap, out_dir, mesh=mesh)

    gen = make_generator(cfg, variables, args.device, mesh=mesh,
                         deterministic=args.deterministic)
    print(f"Using device: {gen.device} | weights {weights} (step {step}) | "
          f"{'batched' if batched else 'unbatched'} target {target} "
          f"overlap {overlap}{' | int8_gates' if gen.int8_gates else ''}")
    out = gen_from_file(gen, Path(args.file).expanduser(), out_dir, batched,
                        target, overlap, hp.mu_law, step=step,
                        seed=args.seed)
    print(f"Wrote {out}")
    return out


if __name__ == "__main__":
    main()
