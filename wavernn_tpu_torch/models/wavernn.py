"""WaveRNN vocoder (fatchord variant): the conditioning network and the
sample-loop parameters, in PyTorch.

Ports ``wavernn_tpu/models/wavernn.py``.  Public functions keep the JAX
package's channel-last ``(B, T, C)`` layout so the two packages compare like
with like; the convolutions run channel-first inside.  BatchNorm runs in
eval mode with the running statistics (the generation path never trains).

The teacher-forced forward pass belongs to the training path and is not
ported yet; the sample loop lives in ``ops/decode.py`` (plain PyTorch) and
``ops/cuda_decode.py`` (the CUDA kernel), which read this module's ``I``,
``rnn1``, ``rnn2`` and ``fc1``-``fc3`` parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class WaveRNNConfig:
    """The model's shape.  The JAX config's XLA-scan tuning knobs
    (``seq_chunks``, ``chunk_warmup``, ``scan_unroll``, ``scan_remat``) and
    its training precision knob (``compute_dtype``) have no counterpart
    here: they shape training, which this package does not run yet."""

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
        )


class ResBlock(nn.Module):
    """1x1-conv residual block with batch norm, on (B, C, T)."""

    def __init__(self, dims: int):
        super().__init__()
        self.conv1 = nn.Conv1d(dims, dims, 1, bias=False)
        self.bn1 = nn.BatchNorm1d(dims, eps=1e-5)
        self.conv2 = nn.Conv1d(dims, dims, 1, bias=False)
        self.bn2 = nn.BatchNorm1d(dims, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return self.bn2(self.conv2(y)) + x


class MelResNet(nn.Module):
    """Conditioning resnet over mels, on (B, C, T).  ``conv_in`` is a VALID
    (2*pad+1)-tap conv, so time shrinks by 2*pad."""

    def __init__(self, res_blocks: int, in_dims: int, compute_dims: int,
                 res_out_dims: int, pad: int):
        super().__init__()
        self.conv_in = nn.Conv1d(in_dims, compute_dims, 2 * pad + 1,
                                 bias=False)
        self.bn = nn.BatchNorm1d(compute_dims, eps=1e-5)
        self.blocks = nn.ModuleList(
            [ResBlock(compute_dims) for _ in range(res_blocks)])
        self.conv_out = nn.Conv1d(compute_dims, res_out_dims, 1)

    def forward(self, m: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv_in(m)))
        for block in self.blocks:
            x = block(x)
        return self.conv_out(x)


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


class WaveRNN(nn.Module):
    """The vocoder's parameters and its conditioning path."""

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

    def upsample_only(self, mels: torch.Tensor):
        """(B, T_mel, feat) mels -> (mels_up, aux), both at sample rate."""
        return self.upsample(mels)

    def upsample_parts(self, mels: torch.Tensor):
        """As :meth:`upsample_only`, with aux left at MEL rate: the kernel
        path broadcasts it inside ``pack_stream``."""
        return self.upsample(mels, stretch_aux=False)


def from_jax_variables(variables, cfg: WaveRNNConfig,
                       device) -> WaveRNN:
    """Build a :class:`WaveRNN` in eval mode on ``device`` from the JAX
    package's numpy pytree ``{"params", "batch_stats"}`` (as
    ``utils.checkpoints.load_pytree`` reads it).

    Layout rules (the inverse of the JAX package's torch converter):
    a Dense kernel (in, out) becomes a Linear weight (out, in); a Conv
    kernel (k, in, out) becomes (out, in, k); GRU ``w_ih``/``w_hh`` (in, 3H),
    already in torch gate order, become ``weight_ih``/``weight_hh``
    (3H, in); BatchNorm scale/bias and the running mean/var map across
    (flax's epsilon, 1e-5, is BatchNorm1d's)."""
    p, s = variables["params"], variables["batch_stats"]
    f32 = lambda a: np.asarray(a, np.float32)
    t = lambda a: f32(a).T
    conv = lambda a: np.transpose(f32(a), (2, 1, 0))
    sd = {}

    def bn(prefix, params, stats):
        sd[f"{prefix}.weight"] = f32(params["scale"])
        sd[f"{prefix}.bias"] = f32(params["bias"])
        sd[f"{prefix}.running_mean"] = f32(stats["mean"])
        sd[f"{prefix}.running_var"] = f32(stats["var"])
        sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    up, ups = p["upsample"], s["upsample"]
    for i in range(len(cfg.upsample_factors)):
        sd[f"upsample.up_kernels.{i}"] = f32(up[f"up{i}_kernel"])
    rp, rs = up["resnet"], ups["resnet"]
    sd["upsample.resnet.conv_in.weight"] = conv(rp["conv_in"]["kernel"])
    bn("upsample.resnet.bn", rp["bn"], rs["bn"])
    for i in range(cfg.res_blocks):
        bp, bs = rp[f"block{i}"], rs[f"block{i}"]
        pre = f"upsample.resnet.blocks.{i}"
        sd[f"{pre}.conv1.weight"] = conv(bp["conv1"]["kernel"])
        bn(f"{pre}.bn1", bp["bn1"], bs["bn1"])
        sd[f"{pre}.conv2.weight"] = conv(bp["conv2"]["kernel"])
        bn(f"{pre}.bn2", bp["bn2"], bs["bn2"])
    sd["upsample.resnet.conv_out.weight"] = conv(rp["conv_out"]["kernel"])
    sd["upsample.resnet.conv_out.bias"] = f32(rp["conv_out"]["bias"])
    for name in ("I", "fc1", "fc2", "fc3"):
        sd[f"{name}.weight"] = t(p[name]["kernel"])
        sd[f"{name}.bias"] = f32(p[name]["bias"])
    for name in ("rnn1", "rnn2"):
        cell = p[name]["cell"]
        sd[f"{name}.weight_ih"] = t(cell["w_ih"])
        sd[f"{name}.weight_hh"] = t(cell["w_hh"])
        sd[f"{name}.bias_ih"] = f32(cell["b_ih"])
        sd[f"{name}.bias_hh"] = f32(cell["b_hh"])

    model = WaveRNN(cfg)
    model.load_state_dict(
        {k: torch.tensor(v) for k, v in sd.items()},
        strict=True)
    return model.to(device).eval()
