"""WaveRNN vocoder (fatchord variant) in PyTorch: the conditioning
network, the teacher-forced training forward and the sample-loop parameters.

Ports ``wavernn_tpu/models/wavernn.py``.  Public functions keep the JAX
package's channel-last ``(B, T, C)`` layout so the two packages compare like
with like; the convolutions run channel-first inside.  In train mode the
BatchNorm layers normalize with the batch statistics and update their
running statistics as flax does (:class:`FlaxBatchNorm`).

The sample loop lives in ``ops/decode.py`` (plain PyTorch) and
``ops/cuda_decode.py`` (the CUDA kernel), which read this module's ``I``,
``rnn1``, ``rnn2`` and ``fc1``-``fc3`` parameters.  :func:`from_jax_variables`
and :func:`to_jax_variables` move a model to and from the JAX package's
pytree layout through one table of parameters (:func:`param_layout`).
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wavernn_tpu_torch.ops.rnn import (
    gru_cell_step, gru_steps, low_dot, low_product,
)
from wavernn_tpu_torch.parallel.mesh import MeshPlan, all_reduce_sum
from wavernn_tpu_torch.parallel.tensor_parallel import (
    full_parameters, local_tensors,
)


@dataclass(frozen=True)
class WaveRNNConfig:
    """The model's shape and its two training options.  The JAX config's
    ``scan_unroll`` and ``scan_remat`` have no counterpart here: they tune
    XLA's scan (its unroll factor, a rematerialized backward) and change
    no result."""

    rnn_dims: int = 512
    fc_dims: int = 512
    bits: int = 9
    pad: int = 2
    upsample_factors: Tuple[int, ...] = (5, 5, 11)
    feat_dims: int = 80
    compute_dims: int = 128
    res_out_dims: int = 128
    res_blocks: int = 10
    hop_length: int = 275
    sample_rate: int = 22050
    mode: str = "MOL"  # 'RAW' | 'MOL'
    # reduced-precision training matmuls ('bfloat16'): the GRUs' two
    # matmuls take operands of this dtype and give float32 results, with
    # the gradients rounded to it as JAX's are; the gate math, the state
    # and every other layer stay float32.  None = float32 throughout.
    compute_dtype: Optional[str] = None
    # sequence-chunked BPTT (train mode only): seq_chunks > 1 splits each
    # (B, T) window into (B*k, chunk_warmup + T/k) rows, each prefixed with
    # the previous chunk's last chunk_warmup teacher-forced samples (zeros
    # for the first), so the recurrences run k times shorter and the
    # gradients truncate at chunk boundaries.  It applies only when k
    # divides T and 0 <= chunk_warmup <= T/k; otherwise the forward runs
    # unchunked.  1 = the reference's semantics.
    seq_chunks: int = 1
    chunk_warmup: int = 128

    @property
    def n_classes(self) -> int:
        if self.mode == "RAW":
            return 2 ** self.bits
        if self.mode == "MOL":
            return 30
        raise ValueError(f"Unknown model mode: {self.mode}")

    @property
    def aux_dims(self) -> int:
        return self.res_out_dims // 4

    @property
    def total_scale(self) -> int:
        t = 1
        for f in self.upsample_factors:
            t *= f
        return t

    @classmethod
    def from_hp(cls, hp) -> "WaveRNNConfig":
        return cls(
            rnn_dims=hp.voc_rnn_dims,
            fc_dims=hp.voc_fc_dims,
            bits=hp.bits,
            pad=hp.voc_pad,
            upsample_factors=tuple(hp.voc_upsample_factors),
            feat_dims=hp.num_mels,
            compute_dims=hp.voc_compute_dims,
            res_out_dims=hp.voc_res_out_dims,
            res_blocks=hp.voc_res_blocks,
            hop_length=hp.hop_length,
            sample_rate=hp.sample_rate,
            mode=hp.voc_mode,
            compute_dtype=hp.get("voc_compute_dtype", None),
            seq_chunks=hp.get("voc_seq_chunks", 1),
            chunk_warmup=hp.get("voc_chunk_warmup", 128),
        )

    def chunks(self, T: int) -> bool:
        """Whether a train-mode forward over T samples is chunked."""
        k = self.seq_chunks
        return k > 1 and T % k == 0 and 0 <= self.chunk_warmup <= T // k


class FlaxBatchNorm(nn.BatchNorm1d):
    """BatchNorm over (B, C, T) with flax's train-mode arithmetic
    (``flax.linen.BatchNorm(momentum=0.9)``): the batch variance is
    E[x^2] - E[x]^2 clipped at 0, and the running statistics move as
    ``ra = 0.9 ra + 0.1 batch`` with that BIASED variance.
    ``nn.BatchNorm1d`` would put the unbiased one into ``running_var``.
    Eval mode normalizes with the running statistics, as
    ``nn.BatchNorm1d`` does (same epsilon, 1e-5).  ``train`` picks the
    mode explicitly (flax's ``use_running_average``); None follows the
    module's ``training`` flag.

    Under a world plan (``plan``, set for the length of a train step's
    forward by :func:`batch_stats_over`) the rank's mean and E[x^2] are
    averaged over the ranks before the variance is formed, through an
    all-reduce that autograd differentiates: the statistics, the running
    averages and the gradients are the global batch's, as XLA's are for a
    batch sharded over a mesh.  Every rank's batch has the same shape."""

    def __init__(self, dims: int):
        super().__init__(dims, eps=1e-5)
        self.plan: Optional[MeshPlan] = None

    def forward(self, x: torch.Tensor, train=None) -> torch.Tensor:
        if not (self.training if train is None else train):
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        mean = x.mean(dim=(0, 2))
        msq = (x * x).mean(dim=(0, 2))
        if self.plan is not None:
            both = all_reduce_sum(torch.cat([mean, msq]), self.plan)
            mean, msq = (both / self.plan.n_data).chunk(2)
        var = torch.clamp(msq - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


@contextlib.contextmanager
def batch_stats_over(model: nn.Module, plan: Optional[MeshPlan]):
    """Within the block, every :class:`FlaxBatchNorm` of ``model`` takes
    its train-mode statistics over the global batch of the world plan
    ``plan`` (nothing changes with None)."""
    norms = [m for m in model.modules() if isinstance(m, FlaxBatchNorm)]
    for m in norms:
        m.plan = plan
    try:
        yield
    finally:
        for m in norms:
            m.plan = None


def flax_conv(in_dims: int, out_dims: int, kernel: int,
              bias: bool) -> nn.Conv1d:
    """A Conv1d with flax ``nn.Conv``'s init laws: lecun-normal weights (a
    normal truncated at two standard deviations, scaled so that the
    variance is 1 / fan_in, fan_in = in_dims * kernel, as flax draws it)
    and a zero bias."""
    conv = nn.Conv1d(in_dims, out_dims, kernel, bias=bias)
    # the std of a unit normal truncated to [-2, 2]
    std = (1.0 / (in_dims * kernel)) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, std=std, a=-2.0 * std,
                              b=2.0 * std)
        if bias:
            conv.bias.zero_()
    return conv


class ResBlock(nn.Module):
    """1x1-conv residual block with batch norm, on (B, C, T)."""

    def __init__(self, dims: int):
        super().__init__()
        self.conv1 = flax_conv(dims, dims, 1, bias=False)
        self.bn1 = FlaxBatchNorm(dims)
        self.conv2 = flax_conv(dims, dims, 1, bias=False)
        self.bn2 = FlaxBatchNorm(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return self.bn2(self.conv2(y)) + x


class MelResNet(nn.Module):
    """Conditioning resnet over mels, on (B, C, T).  ``conv_in`` is a VALID
    (2*pad+1)-tap conv, so time shrinks by 2*pad."""

    def __init__(self, res_blocks: int, in_dims: int, compute_dims: int,
                 res_out_dims: int, pad: int):
        super().__init__()
        self.conv_in = flax_conv(in_dims, compute_dims, 2 * pad + 1,
                                 bias=False)
        self.bn = FlaxBatchNorm(compute_dims)
        self.blocks = nn.ModuleList(
            [ResBlock(compute_dims) for _ in range(res_blocks)])
        self.conv_out = flax_conv(compute_dims, res_out_dims, 1, bias=True)

    def forward(self, m: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv_in(m)))
        for block in self.blocks:
            x = block(x)
        return self.conv_out(x)


def chunk_sequence(t: torch.Tensor, k: int, warmup: int) -> torch.Tensor:
    """(B, T, C) -> (B*k, warmup + T/k, C): the time axis split into k
    chunks, each prefixed with the previous chunk's last ``warmup`` frames
    (zeros for chunk 0, the window start, where the reference also starts
    cold)."""
    B, T, C = t.shape
    L = T // k
    ch = t.reshape(B, k, L, C)
    tails = F.pad(ch[:, :-1, L - warmup:, :], (0, 0, 0, 0, 1, 0))
    return torch.cat([tails, ch], dim=2).reshape(B * k, warmup + L, C)


def unchunk_sequence(y: torch.Tensor, batch: int, k: int,
                     warmup: int) -> torch.Tensor:
    """The inverse of :func:`chunk_sequence` without the warmup frames:
    (B*k, warmup + L, C) -> (B, k*L, C)."""
    _, LW, C = y.shape
    return y.reshape(batch, k, LW, C)[:, :, warmup:, :].reshape(batch, -1, C)


def stretch_time(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour upsample along time: (B, T, C) -> (B, T*scale, C)."""
    return torch.repeat_interleave(x, scale, dim=1)


class UpsampleNetwork(nn.Module):
    """Stretch + learned smoothing convs to sample rate, with the parallel
    aux resnet.  ``forward`` returns (mels_up (B, (T_mel-2*pad)*hop, feat),
    aux) with aux stretched to sample rate, or left at mel rate."""

    def __init__(self, upsample_factors, feat_dims: int, compute_dims: int,
                 res_blocks: int, res_out_dims: int, pad: int):
        super().__init__()
        self.upsample_factors = tuple(upsample_factors)
        self.pad = pad
        self.resnet = MelResNet(res_blocks, feat_dims, compute_dims,
                                res_out_dims, pad)
        # one (2s+1)-tap kernel per scale, shared by every channel
        self.up_kernels = nn.ParameterList([
            nn.Parameter(torch.full((2 * s + 1,), 1.0 / (2 * s + 1)))
            for s in self.upsample_factors
        ])

    @property
    def total_scale(self) -> int:
        return int(np.prod(self.upsample_factors))

    def _cascade(self, x: torch.Tensor) -> torch.Tensor:
        """The literal stretch+conv cascade on (B, T, C), as depthwise
        convs.  Used to probe the composite filter, and as the fallback
        for short inputs or small pads."""
        C = x.shape[-1]
        y = x.transpose(1, 2)
        for scale, w in zip(self.upsample_factors, self.up_kernels):
            y = torch.repeat_interleave(y, scale, dim=2)
            kernel = w.to(y.dtype).view(1, 1, -1).expand(C, 1, -1)
            y = F.conv1d(y, kernel, padding=scale, groups=C)
        return y.transpose(1, 2)

    def forward(self, m: torch.Tensor, stretch_aux: bool = True):
        ts = self.total_scale
        indent = self.pad * ts
        aux = self.resnet(m.transpose(1, 2)).transpose(1, 2)
        if stretch_aux:
            aux = stretch_time(aux, ts)

        # Polyphase form of the cascade (as in the JAX package): its reach
        # is under 2 mel frames, so stretch -> conv -> ... -> conv equals
        # one (total_scale, 2D+1) filter G applied per mel frame.  G is
        # probed from the learned kernels with an identity input.  The
        # indent trim removes the boundary region whenever pad >= D, which
        # makes the two forms agree up to float reassociation.
        D = 2
        B, T, C = m.shape
        L0 = 2 * D + 3
        if self.pad < D or T < L0:
            return self._cascade(m)[:, indent:-indent, :], aux

        eye = torch.eye(L0, dtype=m.dtype, device=m.device)[None]
        R = self._cascade(eye)[0]                       # (L0*ts, L0)
        i0 = D + 1
        G = R[ts * i0: ts * (i0 + 1), i0 - D: i0 + D + 1]   # (ts, 2D+1)
        idx = torch.arange(self.pad, T - self.pad, device=m.device)
        nb = torch.stack([m[:, idx + d] for d in range(-D, D + 1)],
                         dim=2)                         # (B, T-2p, 2D+1, C)
        x = torch.einsum("btdc,qd->btqc", nb, G)
        return x.reshape(B, -1, C), aux


class GRUCell(nn.Module):
    """GRU parameters in PyTorch's layout and gate order (reset, update,
    new): ``weight_ih`` (3H, I), ``weight_hh`` (3H, H)."""

    def __init__(self, in_dims: int, hidden: int):
        super().__init__()
        bound = 1.0 / hidden ** 0.5
        u = lambda *shape: nn.Parameter(
            torch.empty(*shape).uniform_(-bound, bound))
        self.weight_ih = u(3 * hidden, in_dims)
        self.weight_hh = u(3 * hidden, hidden)
        self.bias_ih = u(3 * hidden)
        self.bias_hh = u(3 * hidden)


def gru_sequence(cell: GRUCell, x: torch.Tensor,
                 compute_dtype=None) -> torch.Tensor:
    """The GRU over a whole (B, T, I) sequence from a zero state ->
    (B, T, H).  Its equations are the JAX scan's
    (``wavernn_tpu/ops/rnn.py:171-177``), ``n = tanh(gi_n + r * (W_hn h +
    b_hn))`` with gates in r, z, n order.  In float32 it is cuDNN's fused
    GRU on the card, ATen's on the CPU; :func:`gru_sequence_reference` is
    the same recurrence step by step.  With ``compute_dtype`` (JAX's
    ``GRU.compute_dtype``) the input projection of the whole sequence is
    one product of operands in that dtype and the recurrence runs step by
    step with a float32 state (``ops.rnn.gru_steps``): cuDNN run on bf16
    tensors would keep the state in bf16."""
    if compute_dtype is not None:
        return gru_sequence_low(cell, x, compute_dtype)
    h0 = x.new_zeros(1, x.shape[0], cell.weight_hh.shape[1])
    weights = [cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh]
    with warnings.catch_warnings():
        # the module's own tensors are not one flat cuDNN buffer: cuDNN
        # copies them (4 small matrices) on each call, and warns so
        warnings.filterwarnings("ignore", message="RNN module weights")
        out, _ = torch._VF.gru(x, h0, weights, True, 1, 0.0,
                               torch.is_grad_enabled(), False, True)
    return out


def gru_sequence_low(cell: GRUCell, x: torch.Tensor, compute_dtype,
                     product=low_product) -> torch.Tensor:
    """:func:`gru_sequence` with ``compute_dtype``: the hoisted input
    projection (``wavernn_tpu/ops/rnn.py:160-167``), then the recurrence
    with the reduced-precision hidden matmul.  ``product`` multiplies the
    rounded operands (``ops.rnn.low_product``: cuBLAS's bf16 GEMM with
    float32 output on the card; ``low_product_reference`` is its plain
    version)."""
    gi = low_dot(x, cell.weight_ih.T, compute_dtype,
                 product=product) + cell.bias_ih
    h0 = x.new_zeros(x.shape[0], cell.weight_hh.shape[1])
    return gru_steps(gi, h0, cell.weight_hh.T, cell.bias_hh, compute_dtype,
                     product)[0]


def gru_sequence_reference(cell: GRUCell, x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`gru_sequence`: a Python loop of cell
    steps."""
    h = x.new_zeros(x.shape[0], cell.weight_hh.shape[1])
    w_ih, w_hh = cell.weight_ih.T, cell.weight_hh.T
    ys = []
    for t in range(x.shape[1]):
        h = gru_cell_step(x[:, t], h, w_ih, w_hh, cell.bias_ih, cell.bias_hh)
        ys.append(h)
    return torch.stack(ys, dim=1)


class WaveRNN(nn.Module):
    """The vocoder's parameters, its conditioning path and its
    teacher-forced forward."""

    def __init__(self, cfg: WaveRNNConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        d = c.aux_dims
        self.upsample = UpsampleNetwork(
            c.upsample_factors, c.feat_dims, c.compute_dims, c.res_blocks,
            c.res_out_dims, c.pad)
        self.I = nn.Linear(1 + c.feat_dims + d, c.rnn_dims)
        self.rnn1 = GRUCell(c.rnn_dims, c.rnn_dims)
        self.rnn2 = GRUCell(c.rnn_dims + d, c.rnn_dims)
        self.fc1 = nn.Linear(c.rnn_dims + d, c.fc_dims)
        self.fc2 = nn.Linear(c.fc_dims + d, c.fc_dims)
        self.fc3 = nn.Linear(c.fc_dims, c.n_classes)

    def forward(self, x: torch.Tensor, mels: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (``wavernn_tpu/models/wavernn.py:310-354``).

        x: (B, T) float samples; mels: (B, T/hop + 2*pad, feat) ->
        (B, T, n_classes).  In train mode the BatchNorm layers use and
        update the batch statistics, and with ``cfg.seq_chunks`` the
        layers after the upsampler run on the chunked rows
        (:func:`chunk_sequence`; the upsampler sees the whole windows)."""
        c = self.cfg
        d, k, w = c.aux_dims, c.seq_chunks, c.chunk_warmup
        mels_up, aux = self.upsample(mels)
        B, T = x.shape
        chunked = self.training and c.chunks(T)
        if chunked:
            x = chunk_sequence(x.unsqueeze(-1), k, w)[..., 0]
            mels_up = chunk_sequence(mels_up, k, w)
            aux = chunk_sequence(aux, k, w)
        a1, a2, a3, a4 = (aux[..., i * d:(i + 1) * d] for i in range(4))
        x = self.I(torch.cat([x.unsqueeze(-1), mels_up, a1], dim=-1))
        x = x + gru_sequence(self.rnn1, x, c.compute_dtype)
        x = x + gru_sequence(self.rnn2, torch.cat([x, a2], dim=-1),
                             c.compute_dtype)
        x = F.relu(self.fc1(torch.cat([x, a3], dim=-1)))
        x = F.relu(self.fc2(torch.cat([x, a4], dim=-1)))
        out = self.fc3(x)
        return unchunk_sequence(out, B, k, w) if chunked else out

    def upsample_only(self, mels: torch.Tensor):
        """(B, T_mel, feat) mels -> (mels_up, aux), both at sample rate."""
        return self.upsample(mels)

    def upsample_parts(self, mels: torch.Tensor):
        """As :meth:`upsample_only`, with aux left at MEL rate: the kernel
        path broadcasts it inside ``pack_stream``."""
        return self.upsample(mels, stretch_aux=False)


def num_params(model: nn.Module) -> float:
    """Trainable parameter count in millions."""
    return sum(p.numel() for p in model.parameters()) / 1_000_000


# How a parameter moves between the layouts: a Dense kernel (in, out) is a
# Linear weight (out, in), GRU ``w_ih``/``w_hh`` (in, 3H), already in torch
# gate order, are ``weight_ih``/``weight_hh`` (3H, in), and a Conv kernel
# (k, in, out) is (out, in, k).  Each move is its own inverse.
_MOVES = {
    "copy": lambda a: a,
    "transpose": lambda a: a.T,
    "conv": lambda a: np.transpose(a, (2, 1, 0)),
}


def param_layout(cfg: WaveRNNConfig) -> List[Tuple[str, Tuple[str, ...], str]]:
    """Every parameter as (torch name, flax path under ``params``, move)."""
    out = [(f"upsample.up_kernels.{i}", ("upsample", f"up{i}_kernel"), "copy")
           for i in range(len(cfg.upsample_factors))]
    res = ("upsample", "resnet")

    def bn(name, path):
        out.append((f"{name}.weight", path + ("scale",), "copy"))
        out.append((f"{name}.bias", path + ("bias",), "copy"))

    out.append(("upsample.resnet.conv_in.weight",
                res + ("conv_in", "kernel"), "conv"))
    bn("upsample.resnet.bn", res + ("bn",))
    for i in range(cfg.res_blocks):
        pre, path = f"upsample.resnet.blocks.{i}", res + (f"block{i}",)
        for conv, norm in (("conv1", "bn1"), ("conv2", "bn2")):
            out.append((f"{pre}.{conv}.weight", path + (conv, "kernel"),
                        "conv"))
            bn(f"{pre}.{norm}", path + (norm,))
    out.append(("upsample.resnet.conv_out.weight",
                res + ("conv_out", "kernel"), "conv"))
    out.append(("upsample.resnet.conv_out.bias", res + ("conv_out", "bias"),
                "copy"))
    for name in ("I", "fc1", "fc2", "fc3"):
        out.append((f"{name}.weight", (name, "kernel"), "transpose"))
        out.append((f"{name}.bias", (name, "bias"), "copy"))
    for name in ("rnn1", "rnn2"):
        for t, f, move in (("weight_ih", "w_ih", "transpose"),
                           ("weight_hh", "w_hh", "transpose"),
                           ("bias_ih", "b_ih", "copy"),
                           ("bias_hh", "b_hh", "copy")):
            out.append((f"{name}.{t}", (name, "cell", f), move))
    return out


def stats_layout(cfg: WaveRNNConfig) -> List[Tuple[str, Tuple[str, ...]]]:
    """Every BatchNorm running statistic as (torch buffer name, flax path
    under ``batch_stats``)."""
    norms = [("upsample.resnet.bn", ("upsample", "resnet", "bn"))]
    for i in range(cfg.res_blocks):
        for norm in ("bn1", "bn2"):
            norms.append((f"upsample.resnet.blocks.{i}.{norm}",
                          ("upsample", "resnet", f"block{i}", norm)))
    return [(f"{name}.{buf}", path + (leaf,)) for name, path in norms
            for buf, leaf in (("running_mean", "mean"), ("running_var", "var"))]


def to_jax_tree(tensors: Mapping[str, torch.Tensor],
                cfg: WaveRNNConfig) -> dict:
    """A dict of per-parameter tensors keyed by torch name (the parameters,
    or an optimizer moment of each) -> the flax ``params`` pytree of
    float32 numpy arrays."""
    tree: dict = {}
    for name, path, move in param_layout(cfg):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        a = tensors[name].detach().to("cpu", torch.float32).numpy()
        node[path[-1]] = np.ascontiguousarray(_MOVES[move](a))
    return tree


def from_jax_tree(tree, cfg: WaveRNNConfig) -> Dict[str, np.ndarray]:
    """The inverse of :func:`to_jax_tree`: torch name -> float32 array."""
    out = {}
    for name, path, move in param_layout(cfg):
        node = tree
        for k in path:
            node = node[k]
        out[name] = np.ascontiguousarray(
            _MOVES[move](np.asarray(node, np.float32)))
    return out


def to_jax_variables(model: WaveRNN) -> dict:
    """The JAX-layout numpy pytree ``{"params", "batch_stats"}`` of a port
    model (the inverse of :func:`from_jax_variables`), for a
    ``Generator``, a checkpoint or the JAX package."""
    cfg = model.cfg
    stats: dict = {}
    buffers = dict(model.named_buffers())
    for name, path in stats_layout(cfg):
        node = stats
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = buffers[name].detach().to("cpu", torch.float32) \
            .numpy().copy()
    return {"params": to_jax_tree(full_parameters(model), cfg),
            "batch_stats": stats}


def load_jax_variables(model: WaveRNN, variables) -> None:
    """Copy the JAX package's numpy pytree ``{"params", "batch_stats"}``
    (as ``utils.checkpoints.load_pytree`` reads it) into ``model`` in
    place, on the model's device.  Raises on a missing or misshapen leaf."""
    sd = {k: torch.from_numpy(v.copy()) for k, v in
          from_jax_tree(variables["params"], model.cfg).items()}
    for name, path in stats_layout(model.cfg):
        node = variables["batch_stats"]
        for k in path:
            node = node[k]
        sd[name] = torch.from_numpy(np.array(node, np.float32))
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            sd[name] = buf
    model.load_state_dict(local_tensors(sd, model), strict=True)


def from_jax_variables(variables, cfg: WaveRNNConfig,
                       device) -> WaveRNN:
    """Build a :class:`WaveRNN` in eval mode on ``device`` from the JAX
    package's numpy pytree ``{"params", "batch_stats"}``; the layout rules
    are :func:`param_layout`'s (flax's BatchNorm epsilon, 1e-5, is
    BatchNorm1d's)."""
    model = WaveRNN(cfg)
    load_jax_variables(model, variables)
    return model.to(device).eval()
