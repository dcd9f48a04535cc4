"""Tacotron training CLI of the PyTorch port, with the curriculum schedule
and the GTA export (ports ``train_tacotron.py``).

    python -m wavernn_tpu_torch.train_tacotron --hp_file hp.py \
        [--force_train] [--force_gta] [--profile DIR] [--seed 0] \
        [--device cuda]
    torchrun --nproc_per_node=N -m wavernn_tpu_torch.train_tacotron \
        --hp_file hp.py

It trains on the text/mel pairs ``python -m wavernn_tpu_torch.preprocess``
wrote, through ``hp.tts_schedule``'s sessions of (r, lr, max_step,
batch_size), and resumes from the latest checkpoint pair of
``checkpoints/<tts_model_id>.tacotron/`` in the session its step selects
(the JAX package's file names and layout: a pair either package wrote
resumes in either).  ``--seed`` seeds the dropout and zoneout masks
(each session's generator starts at seed + step; 0, the default, is the
JAX CLI's stream); the weights' init stays at seed 0.  Then it writes ground-truth-aligned mels to
``<data_path>/gta/`` at the r of the stored step, for ``python -m
wavernn_tpu_torch.train_wavernn --gta``.  The device defaults to ``cuda``
and is never swapped for another: without CUDA the command fails.
``--device cpu`` trains on the CPU.  Float32 matmuls, convolutions and
cuDNN's GRU run in full float32 (TF32 off), as the JAX package trains.
Under ``torchrun`` it trains data-parallel, one process per device, as
``train_wavernn`` does (every session's batch size must split evenly over
the ranks); rank 0 alone writes checkpoints, plots and the GTA mels.
"""

from __future__ import annotations

import argparse

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.data.dataset import get_tts_datasets
from wavernn_tpu_torch.models.tacotron import (
    TacotronConfig, from_jax_variables, init_variables,
)
from wavernn_tpu_torch.models.wavernn import num_params
from wavernn_tpu_torch.parallel import distributed
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.text.symbols import symbols
from wavernn_tpu_torch.train_wavernn import restore_on_ranks, start_ranks
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.tacotron import (
    create_gta_features, r_for_step, run_schedule,
)
from wavernn_tpu_torch.utils.profiling import trace


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train Tacotron TTS with the PyTorch port")
    parser.add_argument("--force_train", "-f", action="store_true",
                        help="force the model to train past total steps")
    parser.add_argument("--force_gta", "-g", action="store_true",
                        help="force the model to create GTA features")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler trace of the run to "
                             "DIR/trace.json")
    parser.add_argument("--seed", type=int, default=0,
                        help="the train masks' seed (default 0)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--hp_file", metavar="FILE", default="hparams.py",
                        help="the file to use for the hyperparameters")
    args = parser.parse_args(argv)

    hp.configure(args.hp_file)
    dev, shard_batch = start_ranks(args.device,
                                   [s[3] for s in hp.tts_schedule])
    set_float32_policy()
    paths = Paths(hp.data_path, hp.voc_model_id, hp.tts_model_id)
    print(f"Using device: {dev}")

    print("\nInitialising Tacotron Model...\n")
    cfg = TacotronConfig.from_hp(hp, num_chars=len(symbols))
    # flax's init laws from seed 0, as the JAX CLI's PRNGKey(0)
    model = from_jax_variables(init_variables(cfg, 0), cfg, dev)
    print("Trainable Parameters: %.3fM" % num_params(model))

    optimizer = make_optimizer(hp.tts_schedule[0][1], hp.tts_clip_grad_norm)
    state = new_train_state(model, optimizer)
    state = restore_on_ranks("tts", paths, state)

    if not args.force_gta:
        def get_datasets(batch_size, r):
            return get_tts_datasets(paths.data, batch_size, r)

        with trace(args.profile):
            state = run_schedule(paths, cfg, state, optimizer, get_datasets,
                                 force_train=args.force_train,
                                 shard_batch=shard_batch, seed=args.seed)
        print("Training Complete.")
        print("To continue training increase the schedule in hparams.py or "
              "use --force_train\n")

    print("Creating Ground Truth Aligned Dataset...\n")
    # the r of the checkpoint's schedule position (the reference reads
    # model.r from the restored buffer, ref: train_tacotron.py:108)
    gta_r = r_for_step(state.get_step(), hp.tts_schedule)
    if distributed.is_main():
        train_set, _ = get_tts_datasets(paths.data, 8, gta_r,
                                        drop_last=False)
        create_gta_features(cfg, state, train_set, paths.gta, gta_r)
    distributed.barrier()
    print("\n\nYou can now train WaveRNN on GTA features - use python -m "
          "wavernn_tpu_torch.train_wavernn --gta\n")
    return state


if __name__ == "__main__":
    main()
