"""Sampling from a discretized mixture of logistics (ports
``wavernn_tpu/ops/mol.py::sample_from_discretized_mix_logistic``).

The random numbers come in as arguments, so a caller can hand both packages
the same uniforms, or draw them from an explicit ``torch.Generator``."""

from __future__ import annotations

import math

import torch

LOG_SCALE_MIN = float(math.log(1e-14))
U_MIN, U_MAX = 1e-5, 1.0 - 1e-5


def sample_from_discretized_mix_logistic(
    y: torch.Tensor,
    u_mix: torch.Tensor,
    u_logistic: torch.Tensor,
    log_scale_min: float = LOG_SCALE_MIN,
) -> torch.Tensor:
    """Draw one sample per row of mixture parameters.

    y: (..., 3*nr_mix) = [mixture logits | means | log scales];
    u_mix: (..., nr_mix) and u_logistic: (...) uniforms in (0, 1), clipped
    to [1e-5, 1-1e-5].  Returns samples in [-1, 1] of shape y.shape[:-1]."""
    nr_mix = y.shape[-1] // 3
    u_mix = u_mix.clamp(U_MIN, U_MAX)
    sel = torch.argmax(y[..., :nr_mix] - torch.log(-torch.log(u_mix)), dim=-1)
    one_hot = torch.nn.functional.one_hot(sel, nr_mix).to(y.dtype)
    means = torch.sum(y[..., nr_mix:2 * nr_mix] * one_hot, dim=-1)
    log_scales = torch.clamp(
        torch.sum(y[..., 2 * nr_mix:] * one_hot, dim=-1), min=log_scale_min)
    u = u_logistic.clamp(U_MIN, U_MAX)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log(1.0 - u))
    return torch.clamp(x, -1.0, 1.0)
