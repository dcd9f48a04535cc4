"""Terminal and image display of the port: the in-place status line, the
progress bar, the boxed config table the CLIs print, elapsed-time
formatting, and the attention and spectrogram heatmaps of Tacotron
training (copies of ``wavernn_tpu/utils/display.py``).

matplotlib is optional, and imported on the first plot: without it the
image savers write the arrays as ``.npy`` files instead, so headless
training never fails for want of it."""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np


def progbar(i: int, n: int, size: int = 16) -> str:
    """Block-character progress bar string for step ``i`` of ``n``."""
    done = (i * size) // max(n, 1)
    return "".join("█" if j <= done else "░" for j in range(size))


def stream(message: str) -> None:
    """In-place terminal status line."""
    sys.stdout.write(f"\r{message}")
    sys.stdout.flush()


def simple_table(item_tuples: Sequence[Tuple[object, object]]) -> None:
    """Print a boxed one-row ASCII table of (heading, value) pairs."""
    headings, cells = [], []
    for heading, cell in item_tuples:
        heading, cell = str(heading), str(cell)
        pad = abs(len(heading) - len(cell))
        left, right = " " * (pad // 2), " " * (pad - pad // 2)
        if len(heading) < len(cell):
            heading = left + heading + right
        else:
            cell = left + cell + right
        headings.append(heading)
        cells.append(cell)

    border = head = body = ""
    for i, (h, c) in enumerate(zip(headings, cells)):
        head_piece = f"| {h} "
        body_piece = f"| {c} "
        border += "+" + "-" * (len(head_piece) - 1)
        head += head_piece
        body += body_piece
        if i == len(headings) - 1:
            head += "|"
            body += "|"
            border += "+"
    print(border)
    print(head)
    print(border)
    print(body)
    print(border)
    print(" ")


def time_since(started: float) -> str:
    """Human-readable elapsed time since ``started`` (a time.time() stamp)."""
    elapsed = time.time() - started
    m, s = int(elapsed // 60), int(elapsed % 60)
    if m >= 60:
        return f"{m // 60}h {m % 60}m {s}s"
    return f"{m}m {s}s"


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def save_attention(attn: np.ndarray, path: Path,
                   save_raw: bool = False) -> None:
    """Save an attention-alignment heatmap as ``<stem>.png`` beside
    ``path`` (the convergence diagnostic).  With ``save_raw``, or without
    matplotlib, the matrix is also written as ``<stem>_attention.npy``."""
    path = Path(path)
    plt = _pyplot()
    if save_raw or plt is None:
        np.save(path.parent / f"{path.stem}_attention.npy", np.asarray(attn))
    if plt is None:
        return
    fig = plt.figure(figsize=(12, 6))
    plt.imshow(np.asarray(attn).T, interpolation="nearest", aspect="auto")
    fig.savefig(path.parent / f"{path.stem}.png", bbox_inches="tight")
    plt.close(fig)


def save_spectrogram(M: np.ndarray, path: Path,
                     length: Optional[int] = None) -> None:
    """Save a spectrogram (n_mels, T), flipped so low bins are at the
    bottom and cut to ``length`` frames, as ``<path>.png``; without
    matplotlib as ``<path>_spectrogram.npy``."""
    path = Path(path)
    M = np.flip(np.asarray(M), axis=0)
    if length:
        M = M[:, :length]
    plt = _pyplot()
    if plt is None:
        np.save(f"{path}_spectrogram.npy", M)
        return
    fig = plt.figure(figsize=(12, 6))
    plt.imshow(M, interpolation="nearest", aspect="auto")
    fig.savefig(f"{path}.png", bbox_inches="tight")
    plt.close(fig)
