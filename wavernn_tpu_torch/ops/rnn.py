"""Recurrent cell step in PyTorch's gate convention (ports
``wavernn_tpu/ops/rnn.py::gru_cell_step``)."""

from __future__ import annotations

import torch


def gru_cell_step(x, h, w_ih, w_hh, b_ih, b_hh):
    """One GRU step, gates ordered (reset, update, new).

    x: (B, I), h: (B, H), w_ih: (I, 3H), w_hh: (H, 3H) -> h': (B, H).
    The hidden-side n bias is scaled by the reset gate, as in PyTorch."""
    H = h.shape[-1]
    gi = x @ w_ih + b_ih
    gh = h @ w_hh + b_hh
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h
