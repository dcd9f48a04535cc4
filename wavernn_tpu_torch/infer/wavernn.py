"""Vocoder inference entry points (ports ``wavernn_tpu/infer/wavernn.py``).

``gen_testset`` renders held-out audition utterances next to their ground
truth at checkpoint time (the reference's in-loop listening check), through
the decode kernel on the card.  ``gen_from_file`` copy-synthesizes a
``.npy`` mel, or a ``.wav`` through the STFT/mel front end
(``dsp/audio.py``, which reads ``hp``).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import audio, wavio
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig, to_jax_variables
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.utils.display import stream


def make_generator(cfg: WaveRNNConfig, variables, device, mesh=None,
                   int8_gates=None, **kwargs) -> Generator:
    """A Generator serving int16 PCM (the WAV payload) on ``device``,
    its fold rows sharded over ``mesh`` (a local
    ``parallel.mesh.MeshPlan``) when one is given; ``int8_gates`` is
    ``hp.gen_int8`` when None (as the JAX package's ``make_generator``
    reads it); ``kwargs`` go to :class:`Generator`."""
    if int8_gates is None:
        int8_gates = bool(hp.get("gen_int8", False))
    kwargs.setdefault("output_dtype", "int16")
    return Generator(cfg, variables, device=device, mesh=mesh,
                     int8_gates=int8_gates, **kwargs)


def _timed_generate(gen: Generator, mel, batched, target, overlap, mu_law,
                    save_path: Path, seed: int = 0) -> np.ndarray:
    """Vocode one mel, print the rate in kHz (samples / wall-clock s, the
    card synchronized) and write the WAV; returns the waveform."""
    start = time.perf_counter()
    wav = gen(mel, batched=batched, target=target, overlap=overlap,
              mu_law=mu_law, seed=seed)
    if gen.device.type == "cuda":
        torch.cuda.synchronize(gen.device)
    elapsed = time.perf_counter() - start
    khz = len(wav) / elapsed / 1000.0
    stream(f"| Gen Rate: {khz:.1f}kHz "
           f"({khz * 1000.0 / gen.cfg.sample_rate:.1f}x realtime) "
           f"| {len(wav)} samples | {gen.device}\n")
    if wav.dtype == np.int16:
        wavio.save_pcm16(wav, save_path, gen.cfg.sample_rate)
    else:
        wavio.save_wav(wav, save_path, gen.cfg.sample_rate)
    return wav


def gen_testset(cfg: WaveRNNConfig, state, test_set, samples: int,
                batched: bool, target: int, overlap: int,
                save_path: Path, mesh=None) -> list:
    """Vocode the first ``samples`` held-out utterances beside their
    targets, with a Generator over the training model's current weights
    on the model's device (the decode kernel on the card, one launch per
    utterance, or one per shard of ``mesh``, whose first device is the
    model's).  Returns the paths of the generated WAVs."""
    dev = next(state.model.parameters()).device
    gen = make_generator(cfg, to_jax_variables(state.model), dev, mesh=mesh)
    k = state.get_step() // 1000
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    written = []

    for i, (m, x) in enumerate(test_set, 1):
        if i > samples:
            break
        print(f"\n| Generating: {i}/{samples}")

        x = np.asarray(x)
        bits = 16 if hp.voc_mode == "MOL" else hp.bits
        if hp.mu_law and hp.voc_mode != "MOL":
            x = audio.decode_mu_law(x, 2 ** bits, from_labels=True)
        else:
            x = audio.label_2_float(x, bits)
        audio.save_wav(x, save_path / f"{k}k_steps_{i}_target.wav")

        batch_str = (
            f"gen_batched_target{target}_overlap{overlap}" if batched
            else "gen_NOT_BATCHED"
        )
        out = save_path / f"{k}k_steps_{i}_{batch_str}.wav"
        _timed_generate(gen, m, batched, target, overlap, hp.mu_law, out)
        written.append(out)
    return written


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
    _timed_generate(gen, mel, batched, target, overlap, mu_law, out, seed)
    return out
