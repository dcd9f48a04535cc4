"""The original DeepMind dual-softmax WaveRNN (ports
``wavernn_tpu/models/deepmind_wavernn.py``, after the reference's
``models/deepmind_version.py``).

One big recurrent matrix ``R`` computes the (u, r, e) gates of the whole
hidden state, which is split into coarse and fine halves; 16-bit audio is
emitted as two 8-bit categoricals, the fine one conditioned on the coarse
byte just drawn.  The NB1 example (``examples/nb1_sine_wave.py``) trains it;
the production vocoder is ``models/wavernn.py``.

The parameters keep the JAX module's names and shapes, so a flax
``params`` tree maps onto them leaf for leaf (:func:`from_jax_variables`,
:func:`to_jax_variables`).  :meth:`DeepMindWaveRNN.cell` is the gate algebra
step by step, the plain version.  The teacher-forced
:meth:`DeepMindWaveRNN.forward` runs the whole sequence as one fused GRU
call (cuDNN's on the card, ATen's on the CPU), because the cell is a GRU in
PyTorch's convention (:meth:`DeepMindWaveRNN.gru_weights`): z = u, n = e,
each gate's rows [coarse | fine], the input x_t = [c_{t-1}, f_{t-1}, c_t]
with a zero weight from c_t to the coarse rows.  The JAX package scans the
cell with XLA ops, so no hand-written kernel stands behind it.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

# generation steps per draw of Gumbel noise (bounds the memory of the draw
# at large batches), and per CUDA-graph replay on the card; the first is a
# multiple of the second
NOISE_CHUNK = 1024
GRAPH_STEPS = 64


@dataclass(frozen=True)
class DeepMindWaveRNNConfig:
    hidden_size: int = 896
    quantisation: int = 256

    @property
    def split_size(self) -> int:
        return self.hidden_size // 2


def param_shapes(cfg: DeepMindWaveRNNConfig) -> Dict[str, Tuple[int, ...]]:
    """The flax parameter names and shapes of the JAX module (its
    ``setup``)."""
    hs, s, q = cfg.hidden_size, cfg.split_size, cfg.quantisation
    return {"R": (hs, 3 * hs),
            "O1": (s, s), "b_O1": (s,), "O2": (s, q), "b_O2": (q,),
            "O3": (s, s), "b_O3": (s,), "O4": (s, q), "b_O4": (q,),
            "I_coarse": (2, 3 * s), "b_I_coarse": (3 * s,),
            "I_fine": (3, 3 * s), "b_I_fine": (3 * s,),
            "bias_u": (hs,), "bias_r": (hs,), "bias_e": (hs,)}


def scaled(cls: torch.Tensor) -> torch.Tensor:
    """An 8-bit class as the network's input value in [-1, 1]."""
    return cls.to(torch.float32) / 127.5 - 1.0


class DeepMindWaveRNN(nn.Module):
    """Coarse/fine dual-softmax WaveRNN.  Every parameter is drawn from
    U(-1/sqrt(hidden), 1/sqrt(hidden)), as the JAX module draws them, from
    ``generator`` (torch's default generator when it is None)."""

    def __init__(self, cfg: DeepMindWaveRNNConfig,
                 generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        bound = 1.0 / cfg.hidden_size ** 0.5
        for name, shape in param_shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape).uniform_(-bound, bound,
                                            generator=generator)))

    def _half(self, R_out, x_in, h, half: int) -> torch.Tensor:
        """The new coarse (``half`` 0) or fine (1) half of the state from
        ``R_out = h @ R`` and that half's input projection ``x_in`` (B, 3s),
        both with their biases (``wavernn_tpu/models/deepmind_wavernn.py:
        93-110``)."""
        hs, s = self.cfg.hidden_size, self.cfg.split_size
        lo = half * s

        def gate(k, bias):
            return R_out[:, k * hs + lo:k * hs + lo + s], bias[lo:lo + s]

        (Ru, bu), (Rr, br), (Re, be) = (gate(0, self.bias_u),
                                        gate(1, self.bias_r),
                                        gate(2, self.bias_e))
        u = torch.sigmoid(Ru + x_in[:, :s] + bu)
        r = torch.sigmoid(Rr + x_in[:, s:2 * s] + br)
        e = torch.tanh(r * Re + x_in[:, 2 * s:] + be)
        return u * h[:, lo:lo + s] + (1.0 - u) * e

    def coarse_logits(self, h_c: torch.Tensor) -> torch.Tensor:
        return torch.relu(h_c @ self.O1 + self.b_O1) @ self.O2 + self.b_O2

    def fine_logits(self, h_f: torch.Tensor) -> torch.Tensor:
        return torch.relu(h_f @ self.O3 + self.b_O3) @ self.O4 + self.b_O4

    def cell(self, prev_y: torch.Tensor, coarse_t: torch.Tensor,
             h: torch.Tensor):
        """One recurrent step, the plain version.

        prev_y: (B, 2) scaled [c_{t-1}, f_{t-1}]; coarse_t: (B, 1) scaled
        current coarse; h: (B, hidden).  Returns (h', coarse_logits,
        fine_logits).  The coarse half of the gates sees only [c_{t-1},
        f_{t-1}]; the fine half also sees c_t."""
        R_out = h @ self.R
        coarse_in = prev_y @ self.I_coarse + self.b_I_coarse
        fine_in = (torch.cat([prev_y, coarse_t], dim=1) @ self.I_fine
                   + self.b_I_fine)
        h_c = self._half(R_out, coarse_in, h, 0)
        h_f = self._half(R_out, fine_in, h, 1)
        return (torch.cat([h_c, h_f], dim=1), self.coarse_logits(h_c),
                self.fine_logits(h_f))

    def gru_weights(self):
        """[w_ih (3hs, 3), w_hh (3hs, hs), b_ih, b_hh] of the PyTorch GRU
        that computes :meth:`cell`'s state: gates (r, z=u, n=e), each gate's
        rows [coarse s | fine s], input [c_{t-1}, f_{t-1}, c_t].  ``bias_e``
        sits outside r * (R_e h), so it joins the n gate's input bias.
        Built from the parameters, so gradients flow back to them."""
        hs, s = self.cfg.hidden_size, self.cfg.split_size
        zero_col = self.I_coarse.new_zeros(s, 1)

        def gate(k):
            cols = slice(k * s, (k + 1) * s)
            w = torch.cat([torch.cat([self.I_coarse[:, cols].T, zero_col],
                                     dim=1), self.I_fine[:, cols].T])
            b = torch.cat([self.b_I_coarse[cols], self.b_I_fine[cols]])
            return w, b

        (wu, bu), (wr, br), (we, be) = gate(0), gate(1), gate(2)
        Rt = self.R.T
        return [torch.cat([wr, wu, we]),
                torch.cat([Rt[hs:2 * hs], Rt[:hs], Rt[2 * hs:]]),
                torch.cat([br, bu, be + self.bias_e]),
                torch.cat([self.bias_r, self.bias_u,
                           self.bias_u.new_zeros(hs)])]

    def forward(self, prev_y: torch.Tensor, coarse_t: torch.Tensor):
        """Teacher-forced forward over sequences, as one fused GRU call.

        prev_y: (B, T, 2) scaled previous [coarse, fine]; coarse_t: (B, T,
        1) scaled current coarse.  Returns (coarse_logits (B, T, Q),
        fine_logits (B, T, Q))."""
        x = torch.cat([prev_y, coarse_t], dim=-1)
        h0 = x.new_zeros(1, x.shape[0], self.cfg.hidden_size)
        with warnings.catch_warnings():
            # weights built per call are not one flat cuDNN buffer: cuDNN
            # copies them (4 small matrices) on each call, and warns so
            warnings.filterwarnings("ignore", message="RNN module weights")
            h, _ = torch._VF.gru(x, h0, self.gru_weights(), True, 1, 0.0,
                                 torch.is_grad_enabled(), False, True)
        s = self.cfg.split_size
        return self.coarse_logits(h[..., :s]), self.fine_logits(h[..., s:])

    def forward_reference(self, prev_y: torch.Tensor,
                          coarse_t: torch.Tensor):
        """The plain version of :meth:`forward`: a loop of :meth:`cell`."""
        h = prev_y.new_zeros(prev_y.shape[0], self.cfg.hidden_size)
        oc, of = [], []
        for t in range(prev_y.shape[1]):
            h, c, f = self.cell(prev_y[:, t], coarse_t[:, t], h)
            oc.append(c)
            of.append(f)
        return torch.stack(oc, dim=1), torch.stack(of, dim=1)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise drawn on ``generator``'s device, moved to
    ``device``: the draws are the same wherever the model runs."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def _steps(model: DeepMindWaveRNN, state, noise: torch.Tensor):
    """Generation steps, one per row of ``noise`` (n, 2, B, Q), from
    ``state`` = [h (B, hidden), y (B, 2)], which is updated in place.
    Returns (coarse classes, fine classes) (B, n) and (coarse logits, fine
    logits) (B, n, Q).

    Each step draws the coarse class from the state's coarse half (which
    does not see c_t), then the fine class from the fine half given the
    drawn c_t.  ``h @ R`` depends on h alone, so one product serves both
    halves; the coarse half equals the JAX generator's second cell call."""
    h, y = state
    out = ([], [], [], [])
    for t in range(noise.shape[0]):
        R_out = h @ model.R
        h_c = model._half(R_out, y @ model.I_coarse + model.b_I_coarse, h, 0)
        oc = model.coarse_logits(h_c)
        kc = torch.argmax(oc + noise[t, 0], dim=-1)
        c_scaled = scaled(kc)[:, None]
        fine_in = (torch.cat([y, c_scaled], dim=1) @ model.I_fine
                   + model.b_I_fine)
        h_f = model._half(R_out, fine_in, h, 1)
        of = model.fine_logits(h_f)
        kf = torch.argmax(of + noise[t, 1], dim=-1)
        h = torch.cat([h_c, h_f], dim=1)
        y = torch.cat([c_scaled, scaled(kf)[:, None]], dim=1)
        for acc, x in zip(out, (kc, kf, oc, of)):
            acc.append(x)
    state[0].copy_(h)
    state[1].copy_(y)
    return tuple(torch.stack(acc, 1) for acc in out)


def _graphed_steps(model: DeepMindWaveRNN, state, batch: int):
    """:func:`_steps` for a CUDA model as a CUDA graph of GRAPH_STEPS
    steps: the eager step issues ~60 small kernels a sample from the host,
    which sets its pace.  Returns ``run(noise)``, which replays the graph
    over ``noise`` in slices of GRAPH_STEPS steps (the last one padded:
    its extra steps advance the state past the end, so only a sequence's
    last call may end off a multiple of GRAPH_STEPS)."""
    dev = model.R.device
    noise_s = torch.zeros(GRAPH_STEPS, 2, batch, model.cfg.quantisation,
                          device=dev)
    start = [x.clone() for x in state]
    # one warm-up pass on a side stream before the capture, as
    # torch.cuda.graph asks, then the state as it was
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        _steps(model, state, noise_s)
    torch.cuda.current_stream(dev).wait_stream(side)
    for x, x0 in zip(state, start):
        x.copy_(x0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _steps(model, state, noise_s)

    def run(noise):
        res = []
        for t0 in range(0, noise.shape[0], GRAPH_STEPS):
            k = min(GRAPH_STEPS, noise.shape[0] - t0)
            noise_s[:k].copy_(noise[t0:t0 + k])
            graph.replay()
            res.append([o[:, :k].clone() for o in outs])
        return tuple(torch.cat(r, 1) for r in zip(*res))

    return run


@torch.no_grad()
def _draw(model: DeepMindWaveRNN, seq_len: int, generator: torch.Generator,
          batch: int = 1, graphed: bool = None):
    """Free-running generation of ``batch`` rows (``wavernn_tpu/models/
    deepmind_wavernn.py:136-168``).  Returns (coarse classes, fine classes)
    as (B, T) int64 and (coarse logits, fine logits) as (B, T, Q), all on
    the model's device.  The draws are Gumbel argmaxes, a categorical draw
    by another stream than JAX's; the noise is drawn NOISE_CHUNK steps at
    a time.  ``graphed`` (by default on a CUDA model) replays the steps
    from a CUDA graph: the same kernels on the same inputs."""
    c = model.cfg
    dev = model.R.device
    state = [torch.zeros(batch, c.hidden_size, device=dev),
             torch.zeros(batch, 2, device=dev)]
    if graphed is None:
        graphed = dev.type == "cuda"
    run = (_graphed_steps(model, state, batch) if graphed
           else lambda noise: _steps(model, state, noise))
    outs = []
    for t0 in range(0, seq_len, NOISE_CHUNK):
        n = min(NOISE_CHUNK, seq_len - t0)
        outs.append(run(_gumbel((n, 2, batch, c.quantisation), generator,
                                dev)))
    return tuple(torch.cat(o, 1) for o in zip(*outs))


def generate(model: DeepMindWaveRNN, seq_len: int,
             generator: torch.Generator, batch: int = 1) -> np.ndarray:
    """Free-running 16-bit generation: sample = c * 256 + f - 2^15 (on a
    CUDA model replayed from a CUDA graph).  Returns row 0 as a float32
    waveform in [-1, 1), as the JAX generator does."""
    kc, kf, _, _ = _draw(model, seq_len, generator, batch)
    samples = (kc[0] * 256 + kf[0] - 2 ** 15).cpu().numpy()
    return (samples.astype(np.float64) / 2 ** 15).astype(np.float32)


def to_jax_variables(model: DeepMindWaveRNN) -> dict:
    """The flax variables ``{"params": {...}}`` of a port model, as numpy
    float32."""
    return {"params": {n: p.detach().to("cpu", torch.float32).numpy().copy()
                       for n, p in model.named_parameters()}}


def from_jax_variables(variables, cfg: DeepMindWaveRNNConfig,
                       device) -> DeepMindWaveRNN:
    """A :class:`DeepMindWaveRNN` on ``device`` holding the JAX module's
    ``params``.  Raises on a missing or misshapen leaf."""
    params = variables["params"]
    model = DeepMindWaveRNN(cfg)
    shapes = param_shapes(cfg)
    if set(params) != set(shapes):
        raise KeyError(f"parameters {sorted(set(params) ^ set(shapes))} "
                       "do not match the model's")
    model.load_state_dict({n: torch.from_numpy(np.array(params[n],
                                                        np.float32))
                           for n in shapes}, strict=True)
    return model.to(device)
