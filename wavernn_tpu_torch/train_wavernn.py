"""WaveRNN vocoder training CLI of the PyTorch port (ports
``train_wavernn.py``).

    python -m wavernn_tpu_torch.train_wavernn --hp_file hp.py \
        [--lr LR] [--batch_size B] [--force_train] [--gta] \
        [--profile DIR] [--device cuda]
    torchrun --nproc_per_node=N -m wavernn_tpu_torch.train_wavernn \
        --hp_file hp.py

It trains on the features ``python -m wavernn_tpu_torch.preprocess`` wrote
and resumes from the latest checkpoint pair of ``checkpoints/
<voc_model_id>.wavernn/`` (the JAX package's file names and layout: a pair
either package wrote resumes in either).  The device defaults to ``cuda``
and is never swapped for another: without CUDA the command fails.
``--device cpu`` trains on the CPU.  Float32 matmuls, convolutions and
cuDNN's GRU run in full float32 (TF32 off), as the JAX package trains.

Under ``torchrun`` (or ``WAVERNN_TPU_DISTRIBUTED=1`` with torchrun's
variables) it trains data-parallel, one process per device: each rank
takes ``cuda:LOCAL_RANK`` (or the device ``--device`` names; ``--device
cpu`` trains on CPU ranks over gloo), its share of every global batch of
``--batch_size``, which must split evenly over the ranks, and rank 0
alone writes checkpoints.  ``hp.mesh_shape`` with a model axis, e.g.
``{"data": 2, "model": 2}`` over 4 ranks, splits the batch over the data
axis only; the ranks of one data index train on the same rows (and the
same random crops) with the parameters replicated, as the JAX CLI does.

The JAX CLI's training options reach the model through
``WaveRNNConfig.from_hp``: ``voc_seq_chunks`` / ``voc_chunk_warmup``
(sequence-chunked BPTT) and ``voc_compute_dtype`` (``"bfloat16"``: the
GRUs' matmuls on bf16 operands with float32 results and state).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.data.dataset import get_vocoder_datasets
from wavernn_tpu_torch.models.wavernn import WaveRNN, WaveRNNConfig, num_params
from wavernn_tpu_torch.parallel import distributed
from wavernn_tpu_torch.parallel.mesh import ShardBatch, make_mesh, shard_batch_fn
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.wavernn import voc_train_loop
from wavernn_tpu_torch.utils.checkpoints import restore_checkpoint
from wavernn_tpu_torch.utils.display import simple_table
from wavernn_tpu_torch.utils.profiling import trace


def start_ranks(device: str, batch_sizes: Sequence[int]
                ) -> Tuple[torch.device, Optional[ShardBatch]]:
    """Join the process group the environment asks for (torchrun's
    variables; nothing without them).  Returns this rank's device
    (:func:`parallel.distributed.rank_device`) and, with more than one
    rank, the ``shard_batch`` of its world plan (``hp.mesh_shape`` when
    set must match the world); every batch size must split evenly over
    the data axis.  With a model axis numpy's global generator (the
    vocoder's random crops) is seeded alike on the ranks of one data
    index, from a seed rank 0 draws."""
    distributed.maybe_initialize_distributed(device=device)
    dev = distributed.rank_device(device)
    if distributed.world_size() == 1:
        return dev, None
    plan = make_mesh(hp.get("mesh_shape"), devices=[dev])
    for b in batch_sizes:
        if b % plan.n_data:
            raise ValueError(f"batch size {b} must be evenly divisible by "
                             f"the {plan.n_data} ranks")
    if plan.n_model > 1:
        nccl = torch.distributed.get_backend() == "nccl"
        seed = torch.full((1,), np.random.randint(0, 2 ** 31),
                          dtype=torch.int64, device=dev if nccl else "cpu")
        torch.distributed.broadcast(seed, 0)
        np.random.seed(int(seed[0]) + plan.data_rank)
    print(f"Data-parallel: {plan.describe()}")
    return dev, shard_batch_fn(plan)


def restore_on_ranks(kind: str, paths: Paths, state):
    """``restore_checkpoint(..., create_if_missing=True)`` on rank 0,
    then on the other ranks, which so read the pair rank 0 may have
    written."""
    if distributed.is_main():
        state = restore_checkpoint(kind, paths, state,
                                   create_if_missing=True)
    distributed.barrier()
    if not distributed.is_main():
        state = restore_checkpoint(kind, paths, state)
    return state


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train the WaveRNN vocoder with the PyTorch port")
    parser.add_argument("--lr", "-l", type=float, help="[float] override hparams.py learning rate")
    parser.add_argument("--batch_size", "-b", type=int, help="[int] override hparams.py batch size")
    parser.add_argument("--force_train", "-f", action="store_true",
                        help="force the model to train past total steps")
    parser.add_argument("--gta", "-g", action="store_true", help="train on GTA features")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler trace of the run to "
                             "DIR/trace.json")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--hp_file", metavar="FILE", default="hparams.py",
                        help="the file to use for the hyperparameters")
    args = parser.parse_args(argv)

    hp.configure(args.hp_file)
    if args.lr is None:
        args.lr = hp.voc_lr
    if args.batch_size is None:
        args.batch_size = hp.voc_batch_size
    dev, shard_batch = start_ranks(args.device, [args.batch_size])
    set_float32_policy()

    paths = Paths(hp.data_path, hp.voc_model_id, hp.tts_model_id)
    print(f"Using device: {dev}")

    print("\nInitialising Model...\n")
    cfg = WaveRNNConfig.from_hp(hp)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)               # as the JAX CLI's PRNGKey(0)
        model = WaveRNN(cfg).to(dev)
    print("Trainable Parameters: %.3fM" % num_params(model))

    optimizer = make_optimizer(args.lr, hp.voc_clip_grad_norm)
    state = new_train_state(model, optimizer)
    state = restore_on_ranks("voc", paths, state)

    train_set, test_set = get_vocoder_datasets(paths.data, args.batch_size, args.gta)

    total_steps = 10_000_000 if args.force_train else hp.voc_total_steps

    simple_table([
        ("Remaining", str((total_steps - state.get_step()) // 1000) + "k Steps"),
        ("Batch Size", args.batch_size),
        ("LR", args.lr),
        ("Sequence Len", hp.voc_seq_len),
        ("GTA Train", args.gta),
        ("Start Step", state.get_step()),
    ])

    with trace(args.profile):
        voc_train_loop(paths, cfg, state, optimizer, train_set, test_set,
                       total_steps, lr=args.lr, shard_batch=shard_batch)

    print("Training Complete.")
    print("To continue training increase voc_total_steps in hparams.py or use --force_train")
    return state


if __name__ == "__main__":
    main()
