"""Recurrent cells and sequence RNNs in PyTorch's gate convention (ports
``wavernn_tpu/ops/rnn.py``): GRU gates ordered (reset, update, new), LSTM
gates (input, forget, cell, output).

The sequence modules keep the JAX package's parameter tree and math layout,
``<gru>.cell.{w_ih (I, 3H), w_hh (H, 3H), b_ih, b_hh}``, so that a flax
checkpoint maps onto them leaf for leaf.  A sequence runs as a Python loop
over time with the whole sequence's input projection hoisted out of it;
:class:`BiGRU` can instead run both directions as one fused recurrent call
(cuDNN's on the card, ATen's on the CPU), which the training graph takes.

``compute_dtype`` (e.g. ``"bfloat16"``) runs a cell's two matmuls on
operands in that dtype with float32 results, as the JAX package's
``_dot``; the gate math and the state stay float32 (:func:`low_dot`).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple

import torch
from torch import nn


def low_dtype(compute_dtype: str) -> torch.dtype:
    """A dtype's name (``"bfloat16"``) -> the torch dtype."""
    dt = getattr(torch, str(compute_dtype), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not a torch "
                         "floating-point dtype")
    return dt


def low_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) of two low-precision operands -> float32: cuBLAS's
    mixed-dtype GEMM (``torch.mm(..., out_dtype=float32)``) on the card,
    :func:`low_product_reference` on the CPU, which has no such GEMM.
    Each product of two bf16 values is exact in float32, so the two differ
    only in the order of the float32 sums."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return low_product_reference(a, b)


def low_product_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`low_product`: the float32 matmul of the
    operands' values."""
    return a.float() @ b.float()


class _LowDot(torch.autograd.Function):
    """``x @ w`` on operands rounded to ``dtype``, float32 out, with JAX's
    gradients for ``jnp.dot(x.astype(dt), w.astype(dt),
    preferred_element_type=float32)``: its transpose multiplies the float32
    cotangent by the other (rounded) operand in float32 and rounds that
    product to ``dt``, so both gradients come back as ``dt`` values."""

    @staticmethod
    def forward(ctx, x, w, w_low, dtype, product):
        xl = x.to(dtype).reshape(-1, x.shape[-1])
        ctx.save_for_backward(xl, w_low)
        ctx.meta = (x.shape, x.dtype, w.dtype, dtype)
        return product(xl, w_low).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        xl, wl = ctx.saved_tensors
        shape, x_dtype, w_dtype, dtype = ctx.meta
        g = g.reshape(-1, g.shape[-1]).float()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ wl.float().T).to(dtype).to(x_dtype).reshape(shape)
        if ctx.needs_input_grad[1]:
            gw = (xl.float().T @ g).to(dtype).to(w_dtype)
        return gx, gw, None, None, None


def low_dot(x: torch.Tensor, w: torch.Tensor, compute_dtype,
            w_low: Optional[torch.Tensor] = None,
            product: Callable = low_product) -> torch.Tensor:
    """``x @ w`` (x: (..., K), w: (K, N)) as the JAX package's ``_dot``:
    with ``compute_dtype`` None a plain matmul; else both operands rounded
    to it, a float32 result (``product``: :func:`low_product`, or its plain
    version) and gradients rounded to it as JAX's are.  ``w_low``, when
    given, is ``w`` already rounded (a loop rounds its weight once)."""
    if compute_dtype is None:
        return x @ w
    dt = low_dtype(compute_dtype)
    if w_low is None:
        w_low = w.detach().to(dt)
    return _LowDot.apply(x, w, w_low, dt, product)


def _gru_gates(gi, gh, h, H):
    """h' from the two gate projections (both biases in)."""
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def gru_cell_step(x, h, w_ih, w_hh, b_ih, b_hh, compute_dtype=None):
    """One GRU step, gates ordered (reset, update, new).

    x: (B, I), h: (B, H), w_ih: (I, 3H), w_hh: (H, 3H) -> h': (B, H).
    The hidden-side n bias is scaled by the reset gate, as in PyTorch.
    ``compute_dtype`` runs the two matmuls on operands of that dtype
    (:func:`low_dot`); the gate math and the state stay float32."""
    H = h.shape[-1]
    gi = low_dot(x, w_ih, compute_dtype) + b_ih
    gh = low_dot(h, w_hh, compute_dtype) + b_hh
    return _gru_gates(gi, gh, h, H)


def gru_steps(gi_seq, h, w_hh, b_hh, compute_dtype=None,
              product: Callable = low_product
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU recurrence over a hoisted input projection: ``gi_seq``
    (B, T, 3H) already holds ``x @ w_ih + b_ih``; each step does the
    hidden matmul (:func:`low_dot` with ``compute_dtype``, the weight
    rounded once) and the gate math from ``h`` (B, H).  Returns (outputs
    (B, T, H), final hidden (B, H))."""
    H = h.shape[-1]
    w_low = (None if compute_dtype is None
             else w_hh.detach().to(low_dtype(compute_dtype)))
    ys = []
    for t in range(gi_seq.shape[1]):
        gh = low_dot(h, w_hh, compute_dtype, w_low, product) + b_hh
        h = _gru_gates(gi_seq[:, t], gh, h, H)
        ys.append(h)
    return torch.stack(ys, dim=1), h


def lstm_cell_step(x, h, c, w_ih, w_hh, b_ih, b_hh, compute_dtype=None):
    """One LSTM step, gates ordered (input, forget, cell, output).

    x: (B, I), h, c: (B, H), w_ih: (I, 4H), w_hh: (H, 4H) -> (h', c').
    ``compute_dtype`` as in :func:`gru_cell_step`."""
    H = h.shape[-1]
    gates = (low_dot(x, w_ih, compute_dtype) + low_dot(h, w_hh, compute_dtype)
             + b_ih + b_hh)
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
    step does the hidden matmul and the gate math (:func:`gru_steps`).
    ``compute_dtype`` runs both matmuls on operands of that dtype, as the
    JAX module's field does.  Returns (outputs (B, T, H), final hidden
    (B, H))."""

    def __init__(self, in_dims: int, hidden: int, compute_dtype=None):
        super().__init__()
        self.hidden = hidden
        self.compute_dtype = compute_dtype
        self.cell = GRUWeights(in_dims, hidden)

    def forward(self, xs: torch.Tensor, h0: Optional[torch.Tensor] = None):
        c, cd = self.cell, self.compute_dtype
        h = xs.new_zeros(xs.shape[0], self.hidden) if h0 is None else h0
        gi_seq = low_dot(xs, c.w_ih, cd) + c.b_ih
        return gru_steps(gi_seq, h, c.w_hh, c.b_hh, cd)


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
