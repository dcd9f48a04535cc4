"""NB1: overfit the DeepMind dual-softmax WaveRNN on a sine wave, then
generate it (ports ``examples/nb1_sine_wave.py``, after the reference's
``notebooks/NB1 - Fit a Sine Wave.ipynb``).

    python -m wavernn_tpu_torch.examples.nb1_sine_wave [--steps 500] \\
        [--sample_rate 24000] [--out model_outputs/nb1_sine.wav] \\
        [--device cuda]

One second of a 220 Hz sine becomes 16-bit samples, split into coarse and
fine bytes; the model (hidden 896) is trained teacher-forced on the whole
second with the coarse plus the fine softmax cross-entropy and Adam at
1e-3 (optax's ``adam``, no clip), the loss printed every 10 steps; then it
generates one second from seed 1 and writes it as a WAV.  The model is
drawn from seed 0.  The device defaults to ``cuda`` and is never swapped
for another: without CUDA the command fails.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.dsp import wavio
from wavernn_tpu_torch.dsp.audio import split_signal
from wavernn_tpu_torch.models.deepmind_wavernn import (
    DeepMindWaveRNN, DeepMindWaveRNNConfig, generate,
)
from wavernn_tpu_torch.tools import device_of
from wavernn_tpu_torch.training.state import Adam
from wavernn_tpu_torch.utils.display import stream


def sine_batch(sample_rate: int):
    """The teacher-forced batch of one second of a 220 Hz sine: (prev_y
    (1, T, 2), coarse_t (1, T, 1)) float32 and (target_c, target_f) (1, T)
    int64, T = sample_rate - 1, as numpy."""
    t = np.arange(sample_rate) / sample_rate
    wave = np.sin(2 * np.pi * 220 * t)
    quant = (wave * (2 ** 15 - 0.5)).astype(np.int64)
    coarse, fine = split_signal(quant)
    c_scaled = coarse / 127.5 - 1.0
    f_scaled = fine / 127.5 - 1.0
    prev_y = np.stack([c_scaled[:-1], f_scaled[:-1]], axis=-1)[None]
    coarse_t = c_scaled[1:, None][None]
    return (prev_y.astype(np.float32), coarse_t.astype(np.float32),
            coarse[1:][None], fine[1:][None])


def nb1_loss(model: DeepMindWaveRNN, prev_y, coarse_t, target_c, target_f):
    """The coarse plus the fine softmax cross-entropy, each a mean over
    (B, T)."""
    oc, of = model(prev_y, coarse_t)
    return (F.cross_entropy(oc.flatten(0, 1), target_c.flatten())
            + F.cross_entropy(of.flatten(0, 1), target_f.flatten()))


def train_step(model: DeepMindWaveRNN, opt: Adam, opt_state,
               batch) -> torch.Tensor:
    """One Adam step on ``batch`` (tensors on the model's device); returns
    the loss before the step, on the device (no sync)."""
    loss = nb1_loss(model, *batch)
    loss.backward()
    opt.step(model, opt_state)
    return loss.detach()


def main(argv=None) -> dict:
    """Train, generate and write the WAV.  Returns ``{"losses": every
    step's loss, "wav": the waveform, "path": the WAV's path}``."""
    parser = argparse.ArgumentParser(
        description="NB1: fit a sine wave with the DeepMind WaveRNN")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--sample_rate", type=int, default=24000)
    parser.add_argument("--out", default="model_outputs/nb1_sine.wav")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    dev = device_of(args.device)
    set_float32_policy()
    sr = args.sample_rate
    batch = [torch.from_numpy(a).to(dev) for a in sine_batch(sr)]
    model = DeepMindWaveRNN(DeepMindWaveRNNConfig(hidden_size=896),
                            torch.Generator().manual_seed(0)).to(dev)
    opt = Adam(1e-3)
    opt_state = opt.init(model)
    losses = []
    for i in range(1, args.steps + 1):
        losses.append(train_step(model, opt, opt_state, batch))
        if i % 10 == 0:
            stream(f"step {i}/{args.steps} loss={float(losses[-1]):.4f} ")
    print()

    wav = generate(model, sr, torch.Generator().manual_seed(1))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    wavio.save_wav(wav, out, sr=sr)
    print(f"wrote {out}")
    return {"losses": torch.stack(losses).cpu().numpy() if losses
            else np.zeros(0, np.float32), "wav": wav, "path": out}


if __name__ == "__main__":
    main()
