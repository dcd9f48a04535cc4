"""Terminal display of the port: the in-place status line, the progress
bar, the boxed config table the CLIs print and elapsed-time formatting
(copies of ``progbar``, ``stream``, ``simple_table`` and ``time_since`` of
``wavernn_tpu/utils/display.py``)."""

from __future__ import annotations

import sys
import time
from typing import Sequence, Tuple


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
