"""Profiling hooks (ports ``wavernn_tpu/utils/profiling.py``): a
``torch.profiler`` trace in place of the ``jax.profiler`` one, and the same
human-readable rate meter."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed work on the host and, where CUDA is available,
    the card, and write a chrome trace to ``logdir/trace.json`` (viewable
    in Perfetto or chrome://tracing).  No-op when logdir is None."""
    if logdir is None:
        yield
        return
    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


class RateMeter:
    """Steps/sec + kHz meter matching the reference's live display
    (ref: train_wavernn.py:136, models/fatchord_version.py:267-271)."""

    def __init__(self) -> None:
        self.start = time.time()
        self.items = 0

    def update(self, n: int = 1) -> None:
        self.items += n

    @property
    def rate(self) -> float:
        elapsed = max(time.time() - self.start, 1e-9)
        return self.items / elapsed

    def khz(self, samples: int) -> float:
        elapsed = max(time.time() - self.start, 1e-9)
        return samples / elapsed / 1000.0
