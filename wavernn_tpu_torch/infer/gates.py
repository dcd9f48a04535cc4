"""Quality gates of a free-running text->mel decode (a numpy copy of the
gate math of ``tools/train_golden.py::taco_eval_decode``).

``tts_gates`` scores a decoded mel and its attention against a ground-truth
mel: attention monotonicity and coverage of the text, tempo (the ratio of
tail-trimmed lengths) and a tempo-normalised L1 to the ground truth.
``gates_pass`` applies the repository's TTS gate (``bench.py``'s
``tts_gate``) against the pinned L1 of the float32 decode.
"""

from __future__ import annotations

import numpy as np


def trim_tail(m: np.ndarray, thresh: float = -3.4) -> np.ndarray:
    """Drop the trailing all-silent frames of a (n_mels, T) mel."""
    active = np.nonzero((m > thresh).any(axis=0))[0]
    return m[:, : active[-1] + 1] if len(active) else m


def tts_gates(mel: np.ndarray, attn: np.ndarray, n_symbols: int,
              gt_mel: np.ndarray) -> dict:
    """mel (n_mels, T) on the [-4, 4] scale, attn (T/r, n_symbols), gt_mel
    (n_mels, T_gt) on the [-4, 4] scale."""
    path = attn.argmax(axis=1)
    steps = np.diff(path)
    monotone = float((steps >= 0).mean()) if len(steps) else 0.0
    coverage = float(len(np.unique(path))) / n_symbols
    gen_t, gt_t = trim_tail(mel), trim_tail(gt_mel)
    tempo = gen_t.shape[1] / gt_t.shape[1]
    idx = np.linspace(0.0, gen_t.shape[1] - 1.0, gt_t.shape[1])
    src = np.arange(gen_t.shape[1], dtype=np.float64)
    warped = np.stack([np.interp(idx, src, gen_t[b])
                       for b in range(gen_t.shape[0])])
    l1 = float(np.abs(warped - gt_t).mean())
    return {"attn_monotone": round(monotone, 3),
            "attn_coverage": round(coverage, 3),
            "mel_gt_l1": round(l1, 4),
            "tempo": round(float(tempo), 3),
            "frames": int(mel.shape[1]), "gt_frames": int(gt_mel.shape[1])}


def gates_pass(gates: dict, pinned_l1: float) -> bool:
    """The TTS gate: diagonal attention that covers the text, a tempo
    within (0.6, 1.5), and an L1 to the ground truth in the regime of the
    pinned float32 decode."""
    return (gates["attn_monotone"] >= 0.85
            and gates["attn_coverage"] >= 0.7
            and 0.6 < gates["tempo"] < 1.5
            and gates["mel_gt_l1"] < pinned_l1 * 1.5 + 0.1)
