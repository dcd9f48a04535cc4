"""Fold-with-overlap batched generation and the equal-power crossfade
unfold (ports ``wavernn_tpu/ops/fold.py``).

A long conditioning sequence is cut into overlapping windows that decode as
one batch, then crossfaded back into 1-D audio."""

from __future__ import annotations

from typing import Tuple

import torch


def fold_shape(total_len: int, target: int, overlap: int) -> Tuple[int, int]:
    """(num_folds, padding) for folding a sequence of total_len samples."""
    num_folds = (total_len - overlap) // (target + overlap)
    extended_len = num_folds * (overlap + target) + overlap
    remaining = total_len - extended_len
    padding = 0
    if remaining != 0:
        num_folds += 1
        padding = target + 2 * overlap - remaining
    return num_folds, padding


def fold_with_overlap(x: torch.Tensor, target: int,
                      overlap: int) -> torch.Tensor:
    """(1, T, C) -> (num_folds, target + 2*overlap, C) overlapping windows."""
    _, total_len, _ = x.shape
    num_folds, padding = fold_shape(total_len, target, overlap)
    if padding:
        x = torch.nn.functional.pad(x, (0, 0, 0, padding))
    length = target + 2 * overlap
    starts = torch.arange(num_folds, device=x.device) * (target + overlap)
    idx = starts[:, None] + torch.arange(length, device=x.device)[None, :]
    return x[0][idx]


def xfade_envelopes(overlap: int, dtype=torch.float32, device=None):
    """Equal-power crossfade envelopes with an RNN-warmup silence prefix:
    fade_in = [zeros(overlap//2), sqrt ramp up],
    fade_out = [ones(overlap//2), sqrt ramp down]."""
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = torch.linspace(-1.0, 1.0, fade_len, dtype=dtype, device=device)
    fade_in = torch.sqrt(0.5 * (1.0 + t))
    fade_out = torch.sqrt(0.5 * (1.0 - t))
    fade_in = torch.cat(
        [torch.zeros(silence_len, dtype=dtype, device=device), fade_in])
    fade_out = torch.cat(
        [torch.ones(silence_len, dtype=dtype, device=device), fade_out])
    return fade_in, fade_out


def xfade_and_unfold(y: torch.Tensor, overlap: int) -> torch.Tensor:
    """(num_folds, target + 2*overlap) samples -> crossfaded 1-D audio of
    num_folds*(target+overlap) + overlap samples."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    total_len = num_folds * (target + overlap) + overlap
    fade_in, fade_out = xfade_envelopes(overlap, y.dtype, y.device)
    y = y.clone()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    starts = torch.arange(num_folds, device=y.device) * (target + overlap)
    idx = (starts[:, None]
           + torch.arange(length, device=y.device)[None, :]).reshape(-1)
    out = torch.zeros(total_len, dtype=y.dtype, device=y.device)
    return out.index_add_(0, idx, y.reshape(-1))
