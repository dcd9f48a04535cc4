"""Vocoder inference entry points (ports ``wavernn_tpu/infer/wavernn.py``).

``gen_from_file`` copy-synthesizes a ``.npy`` mel, or a ``.wav`` through the
STFT/mel front end (``dsp/audio.py``, which reads ``hp``).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from wavernn_tpu_torch.dsp import audio, wavio
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops.decode import Generator


def make_generator(cfg: WaveRNNConfig, variables, device,
                   **kwargs) -> Generator:
    """A Generator serving int16 PCM (the WAV payload) on ``device``;
    ``kwargs`` go to :class:`Generator`."""
    kwargs.setdefault("output_dtype", "int16")
    return Generator(cfg, variables, device=device, **kwargs)


def load_mel(path: Path, n_mels: int) -> np.ndarray:
    """A normalized (n_mels, frames) mel: the mel of a ``.wav`` (loaded at
    ``hp.sample_rate``), or a ``.npy`` file checked as the JAX CLI checks
    it."""
    path = Path(path)
    if path.suffix == ".wav":
        return audio.melspectrogram(audio.load_wav(path))
    if path.suffix != ".npy":
        raise ValueError(f"Expected .wav or .npy, got {path.suffix}!")
    mel = np.load(path)
    if mel.ndim != 2 or mel.shape[0] != n_mels:
        raise ValueError(
            f"Expected a numpy array shaped (n_mels, n_hops), got {mel.shape}!")
    lo, hi = np.min(mel), np.max(mel)
    if hi >= 1.01 or lo <= -0.01:
        raise ValueError(
            f"Expected spectrogram range in [0,1] but was [{lo}, {hi}]")
    return mel


def gen_from_file(gen: Generator, load_path: Path, save_dir: Path,
                  batched: bool, target: int, overlap: int, mu_law: bool,
                  step: int = 0, seed: int = 0) -> Path:
    """Vocode one ``.npy`` mel or ``.wav`` and write the WAV (for a
    ``.wav``, the input beside it as ``*_target.wav``); returns its path.
    Prints the generation rate in kHz (samples / wall-clock s)."""
    load_path = Path(load_path)
    mel = load_mel(load_path, gen.cfg.feat_dims)
    batch_str = (f"gen_batched_target{target}_overlap{overlap}" if batched
                 else "gen_NOT_BATCHED")
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    stem = f"__{load_path.stem}__{step // 1000}k_steps"
    if load_path.suffix == ".wav":
        audio.save_wav(audio.load_wav(load_path),
                       save_dir / f"{stem}_target.wav")
    out = save_dir / f"{stem}_{batch_str}.wav"

    start = time.perf_counter()
    wav = gen(mel, batched=batched, target=target, overlap=overlap,
              mu_law=mu_law, seed=seed)
    if gen.device.type == "cuda":
        torch.cuda.synchronize(gen.device)
    elapsed = time.perf_counter() - start
    khz = len(wav) / elapsed / 1000.0
    print(f"| Gen Rate: {khz:.1f}kHz "
          f"({khz * 1000.0 / gen.cfg.sample_rate:.1f}x realtime) "
          f"| {len(wav)} samples | {gen.device}")
    if wav.dtype == np.int16:
        wavio.save_pcm16(wav, out, gen.cfg.sample_rate)
    else:
        wavio.save_wav(wav, out, gen.cfg.sample_rate)
    return out
