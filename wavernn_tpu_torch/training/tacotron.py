"""Tacotron training runtime: the curriculum sessions, the L1 train step,
attention diagnostics and the GTA export (ports
``wavernn_tpu/training/tacotron.py``; ref: train_tacotron.py:68-198).

The curriculum contract is the JAX package's: the restored step counter
selects the active (r, lr, max_step, batch_size) session, so a resumed run
lands in the right session with that session's learning rate, injected
into the existing Adam state without losing its moments.

One train step is the teacher-forced forward in train mode (dropout and
zoneout masks drawn on the model's device from an explicit
``torch.Generator``), L1 on both heads, the backward, optax's clipped Adam
(``training.state``) and the BatchNorm statistics update.  Loss and
gradient norm stay on the device; the loop reads them only every
``display_every`` steps (and at checkpoints and the last step).

Data parallelism runs one process per device, as the vocoder's does
(``training/wavernn.py``); the dropout and zoneout masks are drawn for the
global batch from the generator every rank seeds alike, and each rank
takes its rows, so a data-parallel step is the single-process step.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.models.tacotron import (
    Tacotron, TacotronConfig, draw_train_masks,
)
from wavernn_tpu_torch.models.wavernn import batch_stats_over
from wavernn_tpu_torch.parallel import distributed
from wavernn_tpu_torch.parallel.mesh import (
    MeshPlan, average_gradients_, check_plan, mean_over,
)
from wavernn_tpu_torch.parallel.tensor_parallel import gathered
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.training.state import Adam, TrainState, set_learning_rate
from wavernn_tpu_torch.training.wavernn import append_log
from wavernn_tpu_torch.utils.checkpoints import save_checkpoint
from wavernn_tpu_torch.utils.display import (
    progbar, save_attention, save_spectrogram, simple_table, stream,
)


def tts_batch_to(device, x, m):
    """A collated numpy TTS batch -> (chars int64, mels float32) on
    ``device``."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device, non_blocking=True)
    return t(x).long(), t(m)


def make_tts_train_step(model: Tacotron, optimizer: Adam, r: int,
                        plan: Optional[MeshPlan] = None) -> Callable:
    """The Tacotron train step at r: ``step(state, x, m, generator=None,
    masks=None) -> (state, loss, grad_norm, attn, m2_hat)`` on
    ``state.model`` (which is ``model``), updating ``state`` in place.
    The loss is L1(mel head) + L1(postnet head) (ref losses:
    train_tacotron.py:136-139); loss and grad_norm (the global norm before
    clipping) are 0-d tensors on the device, attn (B, T/r, L) and m2_hat
    (B, T, n_mels) detached.  x and m are numpy batches (``collate_tts``)
    or tensors on the model's device.  ``masks`` are the decoder's four
    masks (``models.tacotron.draw_decoder_masks``); without them the
    forward draws them, and the encoder prenet's, from ``generator``.

    With a world ``plan``, x and m are this rank's rows of the global
    batch: the masks are drawn for the global batch from ``generator``
    (seeded alike on every rank) and sliced to this rank's rows, BatchNorm
    takes the global statistics, the gradients are averaged over the ranks
    before the clip, and the loss returned is the global batch's.  A plan
    with a model axis takes a model sharded over it
    (``parallel.tensor_parallel.shard_params``) or replicated along it;
    the forward gathers each sharded parameter once, not once a decoder
    step."""
    if plan is not None:
        check_plan(plan, True, "make_tts_train_step")

    def step(state: TrainState, x, m, generator=None, masks=None):
        if state.model is not model:
            raise ValueError("the state's model is not the step's model")
        model.train()
        dev = next(model.parameters()).device
        if isinstance(x, np.ndarray):
            x, m = tts_batch_to(dev, x, m)
        encoder_masks = None
        if plan is not None and masks is None:
            encoder_masks, masks = _rank_masks(model.cfg, plan, x, m, r, dev,
                                               generator)
        with batch_stats_over(model, plan), gathered(model):
            m1_hat, m2_hat, attn = model(x, m, r, True, masks=masks,
                                         generator=generator,
                                         encoder_masks=encoder_masks)
        loss = (m1_hat - m).abs().mean() + (m2_hat - m).abs().mean()
        loss.backward()
        if plan is not None:
            average_gradients_(model, plan)
        grad_norm = optimizer.step(model, state.opt_state)
        state.step += 1
        return (state, mean_over(loss.detach(), plan), grad_norm,
                attn.detach(), m2_hat.detach())

    return step


def _rank_masks(cfg: TacotronConfig, plan: MeshPlan, x, m, r: int, dev,
                generator):
    """This rank's rows of the global batch's train-mode masks (its B
    local rows are rows ``[d*B, (d+1)*B)`` of its data index d)."""
    B = x.shape[0]
    rows = slice(plan.data_rank * B, (plan.data_rank + 1) * B)
    enc, dec = draw_train_masks(cfg, B * plan.n_data, x.shape[1],
                                m.shape[1] // r, dev, generator)
    enc = None if enc is None else tuple(e[rows] for e in enc)
    return enc, tuple(d[:, rows] for d in dec)


def tts_train_loop(
    paths: Paths,
    cfg: TacotronConfig,
    state: TrainState,
    optimizer: Adam,
    train_set,
    r: int,
    lr: float,
    train_steps: int,
    attn_example: str,
    shard_batch: Optional[Callable] = None,
    seed: int = 0,
) -> TrainState:
    """Train ``train_steps`` steps at r with learning rate ``lr``: the
    epoch loop with the named checkpoint every ``tts_checkpoint_every``
    steps, the latest pair at epoch ends (wall-clock throttled, never
    skipped at the end), and the attention and mel plots of
    ``attn_example`` (throttled alike).  A non-finite loss or gradient
    norm suppresses every checkpoint until training recovers.  The masks'
    generator is seeded with ``seed + step``.  ``shard_batch``
    (``parallel.mesh.shard_batch_fn`` of a world plan) trains
    data-parallel, as ``voc_train_loop`` does: every rank draws the same
    global batches and masks, and rank 0 alone writes checkpoints, plots
    and the log."""
    plan = shard_batch.plan if shard_batch is not None else None
    main = plan is None or plan.rank == 0
    model = state.model
    set_learning_rate(state.opt_state, lr)
    train_step = make_tts_train_step(model, optimizer, r, plan)
    dev = next(model.parameters()).device

    total_iters = len(train_set)
    host_step = state.get_step()
    epochs = max(1, train_steps // max(total_iters, 1) + 1)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed + host_step)
    msg = ""
    steps_done = 0
    # see voc_train_loop: scalar fetches are throttled to keep the launch
    # queue full; NaN detection lags at most display_every steps
    display_every = max(1, min(10, hp.tts_checkpoint_every))
    state_finite = True   # last fetched loss/grad were finite
    save_min_s = float(hp.get("latest_save_min_interval_s", 30.0))
    last_save = 0.0
    last_plot = 0.0

    for e in range(1, epochs + 1):
        start = time.time()
        running_loss = 0.0
        n_fetched = 0

        for i, (x, m, ids, _) in enumerate(train_set, 1):
            if shard_batch is not None:
                x, m = shard_batch(x, m)
                x = x.long()
                # this rank's utterances, for the attention example
                d = plan.data_rank
                ids = ids[d * len(x):(d + 1) * len(x)]
            else:
                x, m = tts_batch_to(dev, x, m)
            state, loss, grad_norm, attn, m2_hat = train_step(
                state, x, m, generator)
            host_step += 1
            steps_done += 1
            step = host_step
            k = step // 1000

            if i % display_every == 0 or step % hp.tts_checkpoint_every == 0 \
                    or steps_done >= train_steps:
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
                    f"Loss: {avg_loss:#.4} | {speed:#.2} steps/s | Step: {k}k | "
                )
                if main:
                    stream(msg)

            # checkpoint boundaries force a scalar fetch above: a NaN run
            # never overwrites a good pair (ref: train_tacotron.py:145-146)
            if step % hp.tts_checkpoint_every == 0:
                if state_finite and main:
                    save_checkpoint("tts", paths, state,
                                    name=f"taco_step{k}K", is_silent=True)
                if plan is not None:
                    distributed.barrier()

            # attention/mel diagnostics, wall-clock throttled like the
            # latest save (on a tiny corpus the example comes every epoch;
            # data-parallel: when it is among rank 0's rows)
            if (main and attn_example in ids
                    and time.time() - last_plot >= save_min_s):
                last_plot = time.time()
                idx = ids.index(attn_example)
                save_attention(attn[idx, :, :160].cpu().numpy(),
                               paths.tts_attention / f"{step}")
                save_spectrogram(m2_hat[idx].T.cpu().numpy(),
                                 paths.tts_mel_plot / f"{step}", 600)

            if steps_done >= train_steps:
                break

        done = steps_done >= train_steps
        if main:
            if state_finite and (done or time.time() - last_save
                                 >= save_min_s):
                save_checkpoint("tts", paths, state, is_silent=True)
                last_save = time.time()
            append_log(paths.tts_log, msg)
            print(" ")
        if plan is not None:
            distributed.barrier()
        if done:
            break

    return state


def run_schedule(
    paths: Paths,
    cfg: TacotronConfig,
    state: TrainState,
    optimizer: Adam,
    get_datasets: Callable,
    force_train: bool = False,
    train_loop: Callable = None,
    shard_batch: Optional[Callable] = None,
    seed: int = 0,
) -> TrainState:
    """Run the progressive (r, lr, max_step, batch_size) curriculum from
    the session the state's step falls in (ref: train_tacotron.py:68-98).
    ``get_datasets(batch_size, r) -> (train_set, attn_example)``.  ``seed``
    is each session's mask seed (``tts_train_loop``); 0 is the JAX CLI's
    stream."""
    train_loop = train_loop or tts_train_loop

    for i, session in enumerate(hp.tts_schedule):
        current_step = state.get_step()
        r, lr, max_step, batch_size = session
        training_steps = max_step - current_step

        if current_step >= max_step:
            if i == len(hp.tts_schedule) - 1:
                if force_train:
                    training_steps = 999_999_999
                else:
                    break
            else:
                continue

        simple_table([
            (f"Steps with r={r}", str(training_steps // 1000) + "k Steps"),
            ("Batch Size", batch_size),
            ("Learning Rate", lr),
            ("Outputs/Step (r)", r),
        ])

        train_set, attn_example = get_datasets(batch_size, r)
        kwargs = {"shard_batch": shard_batch} if shard_batch is not None else {}
        if seed:
            kwargs["seed"] = seed
        state = train_loop(
            paths, cfg, state, optimizer, train_set, r, lr,
            training_steps, attn_example, **kwargs,
        )

    return state


def r_for_step(step: int, schedule) -> int:
    """The r of the curriculum session a step falls in (the reference
    keeps it as the checkpointed model.r buffer, ref:
    models/tacotron.py:302-308): sessions are (r, lr, max_step, bs)."""
    for r, _, max_step, _ in schedule:
        if step < max_step:
            return r
    return schedule[-1][0]


def create_gta_features(
    cfg: TacotronConfig,
    state: TrainState,
    train_set,
    save_path: Path,
    r: int,
):
    """Export ground-truth-aligned mels for vocoder fine-tuning (ref:
    train_tacotron.py:178-198): the teacher-forced eval-mode postnet head
    of every batch (the training pipeline predicts mels in both heads),
    cut to each utterance's length and rescaled from [-4, 4] to [0, 1] as
    ``(mel + 4) / 8``, saved as ``<id>.npy`` of shape (n_mels, T)."""
    model = state.model
    model.eval()
    dev = next(model.parameters()).device
    save_path = Path(save_path)
    iters = len(train_set)
    with torch.no_grad():
        for i, (x, mels, ids, mel_lens) in enumerate(train_set, 1):
            x, mels = tts_batch_to(dev, x, mels)
            _, gta, _ = model(x, mels, r, False, generate_gta=True)
            gta = gta.cpu().numpy()
            for j, item_id in enumerate(ids):
                mel = gta[j, : mel_lens[j], :].T  # (n_mels, T) on disk
                mel = (mel + 4) / 8
                np.save(save_path / f"{item_id}.npy", mel, allow_pickle=False)
            stream(f"{progbar(i, iters)} {i}/{iters} Batches ")
