"""Sparse-WaveRNN training with the cubic magnitude-pruning schedule (ports
``examples/pruning_example.py``; ref: notebooks/Pruning - Scratchpad.ipynb,
productionized in ``wavernn_tpu_torch/pruning.py``).

    python -m wavernn_tpu_torch.examples.pruning_example [--steps 300] \\
        [--device cuda]

A tiny RAW model (rnn and fc 64, 8 bits, hop 16) trains on one fixed batch
of uniform noise (``np.random.default_rng(0)``) with clipped Adam at 1e-3
while the masks ramp to 90% sparsity (from step 50 over 200 steps, every
25 steps); the measured mask sparsity is printed every 25 steps.  The model
is drawn from ``torch.manual_seed(0)``.  Training only: no kernel runs.  The
device defaults to ``cuda`` and is never swapped for another: without CUDA
the command fails.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.models.wavernn import WaveRNN, WaveRNNConfig
from wavernn_tpu_torch.pruning import PruneConfig, Pruner, measured_sparsity
from wavernn_tpu_torch.tools import device_of
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.wavernn import batch_to, make_train_step
from wavernn_tpu_torch.utils.display import stream

PRUNE = PruneConfig(target_sparsity=0.9, start_step=50, ramp_steps=200,
                    prune_every=25)
REPORT_EVERY = 25


def tiny_config() -> WaveRNNConfig:
    return WaveRNNConfig(
        rnn_dims=64, fc_dims=64, bits=8, pad=2, upsample_factors=(4, 4),
        feat_dims=16, compute_dims=16, res_out_dims=16, res_blocks=1,
        hop_length=16, sample_rate=1000, mode="RAW")


def noise_batch(cfg: WaveRNNConfig, B: int = 8, seed: int = 0):
    """The example's one batch, drawn as the JAX example draws it:
    x (B, 4 hops) uniform in [-1, 1), labels, and mels (B, 4 + 2 pad,
    feat) uniform in [0, 1), as numpy."""
    mel_win, seq_len = 4 + 2 * cfg.pad, 4 * cfg.hop_length
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, seq_len)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (B, seq_len)).astype(np.int32)
    mels = rng.uniform(0, 1, (B, mel_win, cfg.feat_dims)).astype(np.float32)
    return x, y, mels


def train_pruned(model: WaveRNN, batch, steps: int,
                 pcfg: PruneConfig = PRUNE, report=None):
    """``steps`` clipped Adam steps (1e-3, clip 4) on ``batch`` (tensors on
    the model's device), the masks recomputed on ``pcfg``'s cadence after
    each update and applied to the weights, as the JAX example does.
    Returns (every step's loss as a 0-d tensor, [(step, measured sparsity)]
    every REPORT_EVERY steps); ``report(step, loss, sparsity)`` is called at
    each of those."""
    opt = make_optimizer(1e-3, 4.0)
    state = new_train_state(model, opt)
    train_step = make_train_step(opt, model.cfg.mode)
    pruner = Pruner(pcfg)
    masks = pruner.init_masks(model)
    losses, trajectory = [], []
    for _ in range(steps):
        state, loss, _ = train_step(state, *batch)
        step = state.get_step()
        masks = pruner.maybe_update(masks, model, step)
        Pruner.apply(masks, model)
        losses.append(loss)
        if step % REPORT_EVERY == 0:
            s = measured_sparsity(masks)
            trajectory.append((step, s))
            if report is not None:
                report(step, float(loss), s)
    return losses, trajectory


def main(argv=None) -> dict:
    """Train with pruning.  Returns ``{"losses": every step's loss,
    "sparsity": [(step, measured sparsity)] every 25 steps}``."""
    parser = argparse.ArgumentParser(
        description="Sparse WaveRNN training with the cubic pruning ramp")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    dev = device_of(args.device)
    set_float32_policy()
    cfg = tiny_config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = WaveRNN(cfg).to(dev)
    batch = batch_to(dev, *noise_batch(cfg))
    losses, trajectory = train_pruned(
        model, batch, args.steps,
        report=lambda step, loss, s: stream(
            f"step {step} loss={loss:.3f} sparsity={s:.3f}  "))
    print("\ndone")
    return {"losses": (torch.stack(losses).cpu().numpy() if losses
                       else np.zeros(0, np.float32)),
            "sparsity": trajectory}


if __name__ == "__main__":
    main()
