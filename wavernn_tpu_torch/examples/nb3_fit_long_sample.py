"""NB3: fit a long (30-minute-scale) sample through the training stack
(ports ``examples/nb3_fit_long_sample.py``; ref: notebooks/NB3 - Fit a
30min Sample.ipynb).

    python -m wavernn_tpu_torch.examples.nb3_fit_long_sample \\
        [--minutes 1] [--steps 300] [--batch_size 8] [--seq_hops 5] \\
        [--full_size] [--workspace DIR] [--num_workers N] [--device cuda]

Unlike NB2's hand-rolled sampler, this drives the production pipeline end
to end: a synthetic corpus on disk (:func:`synth_corpus`) -> the
preprocess pool -> ``VocoderDataset`` + loader window crops ->
``voc_train_loop`` (checkpoints, the audition on the last step through the
decode kernel on the card, the log).  The model (``hparams.py``'s in RAW
mode, 64-wide unless ``--full_size``) is drawn from
``torch.manual_seed(0)``.  ``--num_workers`` sets the preprocess pool's
processes (its default: one less than the cores).

It checks that the audition wrote WAVs and that the latest weights are on
disk, and, at the default depth (``--steps`` 300 or more), that the loss of
the first batch dropped by at least 0.5; at a cut depth it prints both
losses and says that this check is skipped.  The device defaults to
``cuda`` and is never swapped for another: without CUDA the command fails.
"""

from __future__ import annotations

import argparse
import copy
import tempfile
from pathlib import Path

import numpy as np
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.config import default_hparams_path, hp
from wavernn_tpu_torch.data.dataset import get_vocoder_datasets
from wavernn_tpu_torch.data.preprocess import preprocess_dataset
from wavernn_tpu_torch.dsp import wavio
from wavernn_tpu_torch.models.wavernn import WaveRNN, WaveRNNConfig, num_params
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.tools import device_of
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.wavernn import make_train_step, voc_train_loop
from wavernn_tpu_torch.utils.files import get_files

DEFAULT_STEPS, LOSS_DROP = 300, 0.5
SMALL = dict(voc_rnn_dims=64, voc_fc_dims=64, voc_compute_dims=32,
             voc_res_out_dims=32, voc_res_blocks=2)


def synth_corpus(wav_dir: Path, sr: int, total_seconds: float, n_files: int):
    """A harmonically rich, f0-modulated corpus split into utterances."""
    wav_dir.mkdir(parents=True, exist_ok=True)
    per = total_seconds / n_files
    for i in range(n_files):
        t = np.arange(int(sr * per)) / sr
        f0 = 140.0 + 40.0 * np.sin(2 * np.pi * (0.2 + 0.05 * i) * t) + 15 * i
        phase = 2 * np.pi * np.cumsum(f0) / sr
        y = sum((0.5 ** k) * np.sin((k + 1) * phase) for k in range(3))
        y = (0.4 * y / np.abs(y).max()).astype(np.float32)
        wavio.save_wav(y, wav_dir / f"long_{i:03d}.wav", sr=sr)


def first_batch_loss(step_fn, state, batch) -> float:
    """The loss of one train step on ``batch`` from ``state``, the state
    left as it was (the step runs on a copy: the JAX example discards the
    step's new state)."""
    return float(step_fn(copy.deepcopy(state), *batch)[1])


def seeded_model(cfg: WaveRNNConfig, dev) -> WaveRNN:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return WaveRNN(cfg).to(dev)


def loss_gate(loss0: float, loss1: float, steps: int, default: int,
              drop: float, what: str) -> bool:
    """The JAX example's loss-drop assertion, held at its default depth
    only: a cut run prints that it skips it.  Returns whether it was
    held."""
    if steps < default:
        print(f"loss-drop check skipped: {steps} steps is a cut depth (the "
              f"check, loss drop >= {drop}, is set for {default} steps)")
        return False
    assert loss1 < loss0 - drop, f"training did not reduce the {what}"
    return True


def main(argv=None) -> dict:
    """Returns ``{"loss0", "loss1", "loss_gate" (whether the loss-drop
    check was held), "auditions" (the WAVs), "paths"}``."""
    parser = argparse.ArgumentParser(
        description="NB3: fit a long sample through the training stack")
    parser.add_argument("--minutes", type=float, default=1.0)
    parser.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--seq_hops", type=int, default=5,
                        help="training window length in mel hops")
    parser.add_argument("--full_size", action="store_true",
                        help="use the full 512-dim model")
    parser.add_argument("--workspace", default=None)
    parser.add_argument("--num_workers", type=int, default=None,
                        help="preprocess pool processes")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    dev = device_of(args.device)
    set_float32_policy()
    ws = Path(args.workspace or tempfile.mkdtemp(prefix="nb3_"))
    print(f"workspace: {ws}")

    hp.configure(
        default_hparams_path(), data_path=str(ws / "data"), voc_mode="RAW",
        voc_batch_size=args.batch_size, voc_total_steps=args.steps,
        voc_seq_len=args.seq_hops * 275,
        voc_checkpoint_every=args.steps,  # audition fires on the last step
        voc_gen_at_checkpoint=1, voc_test_samples=2,
        **({} if args.full_size else SMALL),
    )

    synth_corpus(ws / "wavs", hp.sample_rate, args.minutes * 60.0, n_files=12)
    paths = Paths(hp.data_path, hp.voc_model_id, hp.tts_model_id, base=ws)
    preprocess_dataset(get_files(ws / "wavs", ".wav"), paths,
                       n_workers=args.num_workers)

    cfg = WaveRNNConfig.from_hp(hp)
    model = seeded_model(cfg, dev)
    print("Trainable Parameters: %.3fM" % num_params(model))
    opt = make_optimizer(hp.voc_lr * 4, hp.voc_clip_grad_norm)
    state = new_train_state(model, opt)

    train_set, test_set = get_vocoder_datasets(paths.data, args.batch_size,
                                               train_gta=False)

    # baseline loss before training (one fresh batch)
    step_fn = make_train_step(opt, cfg.mode)
    batch0 = next(iter(train_set))
    loss0 = first_batch_loss(step_fn, state, batch0)

    state = voc_train_loop(paths, cfg, state, opt, train_set, test_set,
                           total_steps=args.steps)

    loss1 = first_batch_loss(step_fn, state, batch0)
    print(f"loss {loss0:.3f} -> {loss1:.3f}")
    gated = loss_gate(loss0, loss1, args.steps, DEFAULT_STEPS, LOSS_DROP,
                      "loss")
    wavs = list(paths.voc_output.glob("*.wav"))
    assert wavs, "audition generation wrote no wavs"
    assert paths.voc_latest_weights.exists()
    print(f"OK: {len(wavs)} audition wavs under {paths.voc_output}")
    return {"loss0": loss0, "loss1": loss1, "loss_gate": gated,
            "auditions": wavs, "paths": paths}


if __name__ == "__main__":
    main()
