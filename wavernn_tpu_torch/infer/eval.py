"""Objective vocoder evaluation: copy-synthesis MCD (ports
``wavernn_tpu/infer/eval.py``).

Vocode an utterance from its ground-truth mel, re-extract the mel of the
generated audio, and report the mel-cepstral distortion against the input
mel: aligned, objective, trackable across checkpoints.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import audio
from wavernn_tpu_torch.dsp.metrics import mcd
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops.decode import Generator


def copy_synthesis_mcd(gen: Generator, mel: np.ndarray, *, batched: bool,
                       target: int, overlap: int, mu_law: bool,
                       seed: int = 0,
                       to_float=None) -> Tuple[float, np.ndarray]:
    """Vocode one utterance from its mel; return (MCD vs the input mel,
    wav).

    ``to_float`` turns a packed-egress generator's wire bytes (int16 /
    mulaw8) back into float audio before the spectral analysis, so the
    score is of what a client of that wire format hears."""
    wav = gen(mel, batched=batched, target=target, overlap=overlap,
              mu_law=mu_law, seed=seed)
    if to_float is not None:
        wav = to_float(wav)
    regen_mel = audio.melspectrogram(np.asarray(wav, np.float32))
    T = min(mel.shape[1], regen_mel.shape[1])
    return mcd(mel[:, :T], regen_mel[:, :T]), wav


def eval_testset_mcd(cfg: WaveRNNConfig, variables, test_set, samples: int,
                     batched: bool, target: int, overlap: int,
                     device) -> List[float]:
    """MCD of copy-synthesis for the first ``samples`` held-out
    (mel, wav) pairs, on a float64-egress Generator on ``device``
    (``int8_gates`` as ``hp.gen_int8`` says, as the JAX package's
    ``make_generator`` reads it)."""
    from wavernn_tpu_torch.infer.wavernn import make_generator

    gen = make_generator(cfg, variables, device, output_dtype="float64")
    scores = []
    for i, (m, _x) in enumerate(test_set, 1):
        if i > samples:
            break
        score, _ = copy_synthesis_mcd(
            gen, np.asarray(m), batched=batched, target=target,
            overlap=overlap, mu_law=hp.mu_law)
        scores.append(score)
        print(f"| eval {i}/{samples}: copy-synthesis MCD = {score:.2f} dB")
    if scores:
        print(f"| mean copy-synthesis MCD over {len(scores)} utterances: "
              f"{np.mean(scores):.2f} dB")
    return scores
