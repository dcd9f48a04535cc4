"""WaveRNN vocoder training runtime (ports
``wavernn_tpu/training/wavernn.py``; ref: train_wavernn.py:91-155).

One train step is the teacher-forced forward (chunked, and with
reduced-precision GRU matmuls, as the model's config says:
``WaveRNNConfig.seq_chunks`` / ``compute_dtype``), the loss over the
whole (B, T) logits (RAW cross-entropy or the MOL loss), the backward, optax's clipped Adam (``training.state``)
and the BatchNorm statistics update.  The epoch loop streams progress,
runs the audition generation (through the decode kernel on the card) and
the named checkpoint every ``voc_checkpoint_every`` steps, and rewrites the
latest checkpoint each epoch, throttled by wall clock.

Loss and gradient norm stay on the device; the loop reads them only every
``display_every`` steps (and at checkpoints and the last step), so the
host does not wait for the card on every step.

Data parallelism runs one process per device (``torchrun``): each rank
steps on its rows of the global batch (``parallel.mesh.shard_batch_fn``),
BatchNorm takes the global batch's statistics, and the gradients are
averaged over the ranks before the clip, so that every rank makes the
single-process step's update.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig, batch_stats_over
from wavernn_tpu_torch.ops.mol import discretized_mix_logistic_loss
from wavernn_tpu_torch.parallel import distributed
from wavernn_tpu_torch.parallel.mesh import (
    MeshPlan, average_gradients_, check_plan, mean_over,
)
from wavernn_tpu_torch.parallel.tensor_parallel import (
    gathered, sharded_parameters,
)
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.pruning import Pruner, make_pruner_from_hp
from wavernn_tpu_torch.training.state import Adam, TrainState, set_learning_rate
from wavernn_tpu_torch.utils.checkpoints import save_checkpoint
from wavernn_tpu_torch.utils.display import stream


def append_log(path, msg: str) -> None:
    """Append-only text log (ref: models/fatchord_version.py:410-412)."""
    with open(path, "a") as f:
        print(msg, file=f)


def batch_to(device, x, y, mels):
    """A collated numpy batch -> tensors on ``device`` (labels int64)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device, non_blocking=True)
    return t(x), t(y), t(mels)


def make_train_step(optimizer: Adam, mode: str,
                    plan: Optional[MeshPlan] = None) -> Callable:
    """The vocoder train step: ``step(state, x, y, mels, masks=None) ->
    (state, loss, grad_norm)``, updating ``state`` in place; loss and
    grad_norm are 0-d tensors on the device.  x, y and mels are numpy
    batches (``collate_vocoder``) or tensors on the model's device.

    With ``masks`` (pruning) the forward runs on the masked weights and
    pruned weights are zeroed again after the update, as the JAX step
    does.  With a world ``plan`` the batch is this rank's rows of the
    global batch: BatchNorm takes the global statistics, one all-reduce
    averages the gradients before the clip (which so sees the global
    norm), and the loss returned is the global batch's.  A plan with a
    model axis takes a model that ``parallel.tensor_parallel.shard_params``
    sharded over it, or one replicated along it; the forward gathers each
    sharded parameter once."""
    if mode not in ("RAW", "MOL"):
        raise ValueError(f"Unknown mode {mode}")
    if plan is not None:
        check_plan(plan, True, "make_train_step")

    def step(state: TrainState, x, y, mels, masks=None):
        model = state.model
        model.train()
        dev = next(model.parameters()).device
        if isinstance(x, np.ndarray):
            x, y, mels = batch_to(dev, x, y, mels)
        if masks is not None:
            if sharded_parameters(model):
                raise ValueError("pruning masks take an unsharded model")
            Pruner.apply(masks, model)
        with batch_stats_over(model, plan), gathered(model):
            logits = model(x, mels)
        if mode == "RAW":
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   y.reshape(-1).long())
        else:
            loss = discretized_mix_logistic_loss(logits, y)
        loss.backward()
        if plan is not None:
            average_gradients_(model, plan)
        grad_norm = optimizer.step(model, state.opt_state)
        if masks is not None:
            Pruner.apply(masks, model)
        state.step += 1
        return state, mean_over(loss.detach(), plan), grad_norm

    return step


def voc_train_loop(
    paths: Paths,
    cfg: WaveRNNConfig,
    state: TrainState,
    optimizer: Adam,
    train_set,
    test_set,
    total_steps: int,
    lr: Optional[float] = None,
    shard_batch: Optional[Callable] = None,
    gen_at_checkpoint: bool = True,
) -> TrainState:
    """Epoch/step training loop with in-loop audition + checkpoint cadence.

    ``lr`` (when given) is re-injected into the restored optimizer state,
    so a resumed run honours the configured learning rate (the reference's
    per-run ``param_group['lr'] = lr``, ref: train_wavernn.py:95).

    ``shard_batch`` (``parallel.mesh.shard_batch_fn`` of a world plan)
    trains data-parallel: every rank draws the same global batches (the
    loader's shuffle is seeded alike on every rank; ``collate_vocoder``'s
    random crops are each rank's own, so every utterance of a global batch
    is cropped once, by the rank that trains on it) and steps on its rows
    of each; the logged loss is the global batch's.  Rank 0 alone runs the
    auditions and writes checkpoints and the log, and every rank waits for
    it after each."""
    from wavernn_tpu_torch.infer.wavernn import gen_testset

    plan = shard_batch.plan if shard_batch is not None else None
    main = plan is None or plan.rank == 0
    if lr is not None:
        set_learning_rate(state.opt_state, lr)
    dev = next(state.model.parameters()).device

    # sparse training (voc_prune_* hparams): cubic-ramp magnitude pruning
    # in the step; resume rebuilds the masks from (weights, step)
    pruner = make_pruner_from_hp(hp)
    train_step = make_train_step(optimizer, cfg.mode, plan)
    masks = (pruner.masks_for_resume(state.model, state.get_step())
             if pruner is not None else None)

    total_iters = len(train_set)
    host_step = state.get_step()
    epochs = max(0, (total_steps - host_step) // max(total_iters, 1) + 1)
    msg = ""
    # Fetch loss/grad scalars only every few steps: each fetch waits for
    # the card, so per-step fetching would serialize the launch queue.
    # NaN detection therefore lags by at most display_every steps.
    display_every = max(1, min(10, hp.voc_checkpoint_every))
    state_finite = True   # last fetched loss/grad were finite
    # Epoch-end "latest" saves are wall-clock throttled: on tiny corpora a
    # per-epoch save would dominate the run.  The final save (loop exit)
    # is never skipped.
    save_min_s = float(hp.get("latest_save_min_interval_s", 30.0))
    last_save = 0.0

    for e in range(1, epochs + 1):
        start = time.time()
        running_loss = 0.0
        n_fetched = 0

        for i, (x, y, mels) in enumerate(train_set, 1):
            x, y, mels = (shard_batch(x, y, mels) if shard_batch is not None
                          else batch_to(dev, x, y, mels))
            if pruner is not None:
                masks = pruner.maybe_update(masks, state.model, host_step + 1)
            state, loss, grad_norm = train_step(state, x, y, mels, masks)
            host_step += 1
            step = host_step
            k = step // 1000

            at_checkpoint = step % hp.voc_checkpoint_every == 0
            if i % display_every == 0 or at_checkpoint or step >= total_steps:
                loss_f, gn_f = float(loss), float(grad_norm)
                state_finite = np.isfinite(loss_f) and np.isfinite(gn_f)
                if not state_finite:
                    print(f"\nWARNING: non-finite loss/grad at step {step} "
                          f"(loss={loss_f}, grad_norm={gn_f}) — checkpoints "
                          "suppressed until training recovers!")
                running_loss += loss_f
                n_fetched += 1
                avg_loss = running_loss / n_fetched
                speed = i / (time.time() - start)
                msg = (
                    f"| Epoch: {e}/{epochs} ({i}/{total_iters}) | "
                    f"Loss: {avg_loss:.4f} | {speed:.1f} steps/s | Step: {k}k | "
                )
                if main:
                    stream(msg)

            if at_checkpoint:
                # the scalars were fetched this step (at_checkpoint forces
                # the fetch): a NaN run never overwrites a good pair (ref
                # NaN-guard intent: train_wavernn.py:129-130)
                if state_finite and main:
                    if gen_at_checkpoint:
                        gen_testset(
                            cfg, state, test_set, hp.voc_gen_at_checkpoint,
                            hp.voc_gen_batched, hp.voc_target, hp.voc_overlap,
                            paths.voc_output,
                        )
                    save_checkpoint("voc", paths, state,
                                    name=f"wave_step{k}K", is_silent=True)
                if plan is not None:
                    distributed.barrier()

            if step >= total_steps:
                break

        done = host_step >= total_steps
        if main:
            if state_finite and (done or time.time() - last_save
                                 >= save_min_s):
                save_checkpoint("voc", paths, state, is_silent=True)
                last_save = time.time()
            append_log(paths.voc_log, msg)
            print(" ")
        if plan is not None:
            distributed.barrier()
        if done:
            break

    return state
