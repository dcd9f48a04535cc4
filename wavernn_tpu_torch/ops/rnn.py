"""Recurrent cells and sequence RNNs in PyTorch's gate convention (ports
``wavernn_tpu/ops/rnn.py``): GRU gates ordered (reset, update, new), LSTM
gates (input, forget, cell, output).

The sequence modules keep the JAX package's parameter tree and math layout,
``<gru>.cell.{w_ih (I, 3H), w_hh (H, 3H), b_ih, b_hh}``, so that a flax
checkpoint maps onto them leaf for leaf.  A sequence runs as a Python loop
over time with the whole sequence's input projection hoisted out of it;
:class:`BiGRU` can instead run both directions as one fused recurrent call
(cuDNN's on the card, ATen's on the CPU), which the training graph takes.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn


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


def lstm_cell_step(x, h, c, w_ih, w_hh, b_ih, b_hh):
    """One LSTM step, gates ordered (input, forget, cell, output).

    x: (B, I), h, c: (B, H), w_ih: (I, 4H), w_hh: (H, 4H) -> (h', c')."""
    H = h.shape[-1]
    gates = x @ w_ih + h @ w_hh + b_ih + b_hh
    i = torch.sigmoid(gates[..., :H])
    f = torch.sigmoid(gates[..., H:2 * H])
    g = torch.tanh(gates[..., 2 * H:3 * H])
    o = torch.sigmoid(gates[..., 3 * H:])
    c = f * c + i * g
    return o * torch.tanh(c), c


def _uniform(bound: float, *shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape).uniform_(-bound, bound))


class GRUWeights(nn.Module):
    """The ``cell`` parameters of a sequence GRU, in the math layout."""

    def __init__(self, in_dims: int, hidden: int):
        super().__init__()
        bound = 1.0 / hidden ** 0.5
        self.w_ih = _uniform(bound, in_dims, 3 * hidden)
        self.w_hh = _uniform(bound, hidden, 3 * hidden)
        self.b_ih = _uniform(bound, 3 * hidden)
        self.b_hh = _uniform(bound, 3 * hidden)


class GRU(nn.Module):
    """Unidirectional GRU over a (B, T, I) sequence.  The input-side gate
    projection of the whole sequence is one matmul before the loop; each
    step does the hidden matmul and the gate math.  Returns (outputs
    (B, T, H), final hidden (B, H))."""

    def __init__(self, in_dims: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.cell = GRUWeights(in_dims, hidden)

    def forward(self, xs: torch.Tensor, h0: Optional[torch.Tensor] = None):
        c, H = self.cell, self.hidden
        B, T, _ = xs.shape
        h = xs.new_zeros(B, H) if h0 is None else h0
        gi_seq = xs @ c.w_ih + c.b_ih
        ys = []
        for t in range(T):
            gi = gi_seq[:, t]
            gh = h @ c.w_hh + c.b_hh
            r = torch.sigmoid(gi[:, :H] + gh[:, :H])
            z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
            h = (1.0 - z) * n + z * h
            ys.append(h)
        return torch.stack(ys, dim=1), h


class BiGRU(nn.Module):
    """Bidirectional GRU: (B, T, I) -> (B, T, 2H), forward outputs then
    backward ones.  The backward GRU runs over the flipped sequence and its
    outputs are flipped back.

    With ``fused`` both directions are one call of PyTorch's fused GRU
    (``torch._VF.gru``, bidirectional: cuDNN's on the card, ATen's on the
    CPU) from a zero state.  Its equations are the loop's, so the two agree
    to float32 rounding; the loop stays the plain version, and generation
    keeps it."""

    def __init__(self, in_dims: int, hidden: int):
        super().__init__()
        self.fwd = GRU(in_dims, hidden)
        self.bwd = GRU(in_dims, hidden)

    def forward(self, xs: torch.Tensor, fused: bool = False) -> torch.Tensor:
        if fused:
            return self._fused(xs)
        fwd, _ = self.fwd(xs)
        bwd, _ = self.bwd(torch.flip(xs, dims=[1]))
        return torch.cat([fwd, torch.flip(bwd, dims=[1])], dim=-1)

    def _fused(self, xs: torch.Tensor) -> torch.Tensor:
        h0 = xs.new_zeros(2, xs.shape[0], self.fwd.hidden)
        weights = []
        for c in (self.fwd.cell, self.bwd.cell):
            # the fused call takes PyTorch's layout, (3H, in)
            weights += [c.w_ih.t().contiguous(), c.w_hh.t().contiguous(),
                        c.b_ih, c.b_hh]
        with warnings.catch_warnings():
            # the weights are not one flat cuDNN buffer: cuDNN copies them
            # on each call, and warns so
            warnings.filterwarnings("ignore", message="RNN module weights")
            out, _ = torch._VF.gru(xs, h0, weights, True, 1, 0.0,
                                   torch.is_grad_enabled(), True, True)
        return out
