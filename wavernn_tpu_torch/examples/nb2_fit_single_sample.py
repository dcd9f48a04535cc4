"""NB2: overfit the production WaveRNN on a single utterance and
copy-synthesize it (ports ``examples/nb2_fit_single_sample.py``; ref:
notebooks/NB2 - Fit a 30min Sample.ipynb).

    python -m wavernn_tpu_torch.examples.nb2_fit_single_sample \\
        --wav path/to.wav [--steps 2000] [--batch_size 16] \\
        [--hp_file hparams.py] [--device cuda]

The ``--hp_file`` model (``hparams.py``'s by default, full width) in RAW
mode, drawn from ``torch.manual_seed(0)``, trains with clipped Adam at 4x
``voc_lr`` on windows of the one utterance, cut by a hand-rolled sampler
(``np.random.default_rng(0)``), the loss printed every 20 steps; then the
first 400 mel frames are generated (batched folds of ``voc_target`` /
``voc_overlap``; on the card through the decode kernel) and written next to
the input as ``<stem>.resynth.wav``.  The device defaults to ``cuda`` and
is never swapped for another: without CUDA the command fails.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.config import default_hparams_path, hp
from wavernn_tpu_torch.dsp import audio
from wavernn_tpu_torch.models.wavernn import (
    WaveRNN, WaveRNNConfig, num_params, to_jax_variables,
)
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.tools import device_of
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.wavernn import make_train_step
from wavernn_tpu_torch.utils.display import stream

GEN_FRAMES = 400


def utterance(wav_path):
    """(mel (n_mels, T) float32, mu-law labels int64) of one wav, at
    ``hp``'s settings."""
    y = audio.load_wav(wav_path)
    mel = audio.melspectrogram(y).astype(np.float32)
    labels = audio.encode_mu_law(y, 2 ** hp.bits).astype(np.int64)
    return mel, labels


def window_batch(rng: np.random.Generator, mel: np.ndarray,
                 labels: np.ndarray, batch_size: int):
    """One batch of random windows of the utterance, as the JAX example
    cuts it: x (B, voc_seq_len) float32 samples in [-1, 1), targets (B,
    voc_seq_len) int32 and mels (B, mel_win, n_mels) float32."""
    mel_win = hp.voc_seq_len // hp.hop_length + 2 * hp.voc_pad
    max_off = mel.shape[1] - 2 - (mel_win + 2 * hp.voc_pad)
    offs = rng.integers(0, max_off, batch_size)
    ms = np.stack([mel[:, o: o + mel_win] for o in offs]).transpose(0, 2, 1)
    sig = [labels[(o + hp.voc_pad) * hp.hop_length:][: hp.voc_seq_len + 1]
           for o in offs]
    lab = np.stack(sig)
    x = audio.label_2_float(lab[:, :-1].astype(np.float32), hp.bits)
    return x.astype(np.float32), lab[:, 1:].astype(np.int32), ms


def main(argv=None) -> dict:
    """Train on the utterance, then write its re-synthesis.  Returns
    ``{"losses": every step's loss, "wav": the waveform, "path": the WAV's
    path}``."""
    parser = argparse.ArgumentParser(
        description="NB2: overfit the WaveRNN on one utterance")
    parser.add_argument("--wav", required=True)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--hp_file", default=str(default_hparams_path()))
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    dev = device_of(args.device)
    set_float32_policy()
    hp.configure(args.hp_file, voc_mode="RAW")
    cfg = WaveRNNConfig.from_hp(hp)
    mel, labels = utterance(args.wav)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = WaveRNN(cfg).to(dev)
    print("Trainable Parameters: %.3fM" % num_params(model))
    opt = make_optimizer(hp.voc_lr * 4, hp.voc_clip_grad_norm)
    state = new_train_state(model, opt)
    train_step = make_train_step(opt, cfg.mode)

    rng = np.random.default_rng(0)
    losses = []
    for i in range(1, args.steps + 1):
        state, loss, _ = train_step(state, *window_batch(
            rng, mel, labels, args.batch_size))
        losses.append(loss)
        if i % 20 == 0:
            stream(f"step {i}/{args.steps} loss={float(loss):.4f} ")
    print()

    gen = Generator(cfg, to_jax_variables(model), device=dev)
    wav = gen(mel[:, :GEN_FRAMES], batched=True, target=hp.voc_target,
              overlap=hp.voc_overlap, mu_law=hp.mu_law)
    out = Path(args.wav).with_suffix(".resynth.wav")
    audio.save_wav(wav, out)
    print(f"wrote {out}")
    return {"losses": (torch.stack(losses).cpu().numpy() if losses
                       else np.zeros(0, np.float32)),
            "wav": wav, "path": out}


if __name__ == "__main__":
    main()
