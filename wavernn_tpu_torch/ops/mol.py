"""The discretized mixture of logistics (ports ``wavernn_tpu/ops/mol.py``):
the training loss and sampling.

Sampling takes its random numbers as arguments, so a caller can hand both
packages the same uniforms, or draw them from an explicit
``torch.Generator``."""

from __future__ import annotations

import math

import torch

LOG_SCALE_MIN = float(math.log(1e-14))
U_MIN, U_MAX = 1e-5, 1.0 - 1e-5


def discretized_mix_logistic_loss(
    y_hat: torch.Tensor,
    y: torch.Tensor,
    num_classes: int = 65536,
    log_scale_min: float = LOG_SCALE_MIN,
    reduce: bool = True,
) -> torch.Tensor:
    """Negative log-likelihood of y under the discretized MoL
    (``wavernn_tpu/ops/mol.py:24-78``).

    y_hat: (B, T, 3*nr_mix) = [mixture logits | means | log scales];
    y: (B, T) or (B, T, 1) targets in [-1, 1].  Every branch input is
    clamped as in the JAX loss (the log-scale floor, the 1e-12 floor under
    the in-bin mass, the softplus forms of the edge terms), so that a
    ``torch.where`` branch that is not selected cannot send an inf or NaN
    into the gradient.

    One deliberate difference: the in-bin mass ``sigmoid(plus) -
    sigmoid(min)`` is computed as ``sigmoid(plus) * sigmoid(-min) *
    (1 - exp(-(plus - min)))``, the same quantity without the cancellation.
    A bin is 2/65535 wide, so the mass is near the 1e-5 switch to the
    density branch, and the float32 difference of two sigmoids near 0.5
    keeps about two digits of it: the JAX loss's float32 gradient is
    1.4e-3 (relative L2) away from its own float64 value on a fresh
    model's logits, and each device (the card's ``expf``, the CPU's)
    would draw that noise differently.  This form is within 1e-6 of the
    float64 value."""
    nr_mix = y_hat.shape[-1] // 3
    if y.dim() == y_hat.dim() - 1:
        y = y.unsqueeze(-1)
    softplus = torch.nn.functional.softplus

    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp(y_hat[..., 2 * nr_mix:], min=log_scale_min)

    centered_y = y - means
    inv_stdv = torch.exp(-log_scales)
    half_bin = 1.0 / (num_classes - 1)
    plus_in = inv_stdv * (centered_y + half_bin)
    min_in = inv_stdv * (centered_y - half_bin)

    log_cdf_plus = plus_in - softplus(plus_in)        # log CDF, left edge
    log_one_minus_cdf_min = -softplus(min_in)         # log SF, right edge
    cdf_delta = (torch.sigmoid(plus_in) * torch.sigmoid(-min_in)
                 * -torch.expm1(-2.0 * half_bin * inv_stdv))

    mid_in = inv_stdv * centered_y
    log_pdf_mid = mid_in - log_scales - 2.0 * softplus(mid_in)

    # underflow fallback: the bin mass as density times bin width
    inner_inner = torch.where(
        cdf_delta > 1e-5,
        torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2.0))
    inner = torch.where(y > 0.999, log_one_minus_cdf_min, inner_inner)
    log_probs = torch.where(y < -0.999, log_cdf_plus, inner)

    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    lse = torch.logsumexp(log_probs, dim=-1)
    if reduce:
        return -torch.mean(lse)
    return -lse.unsqueeze(-1)


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
