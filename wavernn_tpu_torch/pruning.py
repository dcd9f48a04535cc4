"""Magnitude pruning with a cubic sparsity ramp (ports
``wavernn_tpu/pruning.py``; the WaveRNN paper's scheme, prototyped in the
reference's ``notebooks/Pruning - Scratchpad.ipynb``):

   z(t) = Z * (1 - (1 - (t - t0)/S)^3)   for t in [t0, t0 + S]

Per-matrix magnitude masks are recomputed every ``prune_every`` steps; GRU
weight matrices are masked *per gate block*, so each gate keeps its own
top-magnitude weights.

Masks are a dict of tensors keyed by the model's parameter names (ones for
the parameters that are not pruned), element for element the JAX package's
masks moved to the port's layout.  The selection rule keys on the flax
names (``models.wavernn.param_layout``): GRU ``w_ih``/``w_hh`` are gated,
a 2-D Dense ``kernel`` whose smaller side is at least 64 is masked whole.
A gate block is a third of the flax (in, 3H) kernel's OUTPUT axis, which
is a block of rows of the port's (3H, in) ``weight_ih``/``weight_hh``:
the same elements either way, so the threshold and the mask agree.  The
schedule and the kept count are computed in float32 on the host, as the
JAX package computes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wavernn_tpu_torch.models.wavernn import param_layout

Masks = Dict[str, torch.Tensor]
_F32 = np.float32


@dataclass(frozen=True)
class PruneConfig:
    target_sparsity: float = 0.9375        # Z in the paper's schedule
    start_step: int = 20_000                # t0
    ramp_steps: int = 480_000               # S
    prune_every: int = 500
    gate_splits: int = 3                    # GRU gate blocks (LSTM: 4)


def sparsity_at(step: int, cfg: PruneConfig) -> np.float32:
    """Cubic ramp z(t) in float32; 0 before start, Z after the ramp."""
    t = _F32(step)
    frac = np.clip((t - _F32(cfg.start_step)) / _F32(cfg.ramp_steps),
                   _F32(0), _F32(1)).astype(_F32)
    u = _F32(1) - frac
    return _F32(cfg.target_sparsity) * (_F32(1) - u * u * u)


def _kept_index(z: np.float32, n: int) -> int:
    """The sorted position of the threshold: ``clip(int32(z * n), 0,
    n-1)``, the product in float32."""
    return int(np.clip(int(_F32(z) * _F32(n)), 0, n - 1))


def _block_mask(w: torch.Tensor, z, n_blocks: int) -> torch.Tensor:
    """Keep the top-(1-z) magnitude entries independently per gate block of
    a (n_blocks*H, in) matrix (ties kept: ``mag >= thresh``)."""
    mag = w.detach().abs().reshape(n_blocks, -1)
    k = _kept_index(z, mag.shape[1])
    thresh = torch.sort(mag, dim=1).values[:, k:k + 1]
    return (mag >= thresh).to(w.dtype).reshape(w.shape)


def _full_mask(w: torch.Tensor, z) -> torch.Tensor:
    mag = w.detach().abs()
    k = _kept_index(z, mag.numel())
    thresh = torch.sort(mag.reshape(-1)).values[k]
    return (mag >= thresh).to(w.dtype)


def default_prunable(flax_path: Tuple[str, ...],
                     flax_shape: Tuple[int, ...]) -> Optional[str]:
    """Which leaves to prune, by the flax path and shape of the leaf:
    'gated' (per-gate-block mask), 'full', or None.  Mirrors the reference
    prototype's choice of Linear/GRU weights."""
    names = "/".join(flax_path)
    if len(flax_shape) != 2:
        return None
    if "w_ih" in names or "w_hh" in names:
        return "gated"
    if "kernel" in names and min(flax_shape) >= 64:
        return "full"
    return None


class Pruner:
    """Stateful scheduler mirroring the reference's ``Pruner`` (recompute
    masks on a cadence, cubic sparsity ramp, restart-safe because
    everything derives from the step counter)."""

    def __init__(self, cfg: PruneConfig):
        self.cfg = cfg

    def compute(self, model, step: int) -> Masks:
        """The masks of ``model``'s current weights at ``step``."""
        z = sparsity_at(step, self.cfg)
        params = dict(model.named_parameters())
        masks = {}
        for name, path, move in param_layout(model.cfg):
            w = params[name]
            # the flax leaf's shape: a transposed Dense / GRU matrix
            shape = tuple(w.shape[::-1]) if move == "transpose" else \
                tuple(w.shape)
            kind = default_prunable(path, shape)
            if kind == "gated" and shape[1] % self.cfg.gate_splits == 0:
                masks[name] = _block_mask(w, z, self.cfg.gate_splits)
            elif kind in ("gated", "full"):
                masks[name] = _full_mask(w, z)
            else:
                masks[name] = torch.ones_like(w, requires_grad=False)
        return masks

    def init_masks(self, model) -> Masks:
        return {n: torch.ones_like(p, requires_grad=False)
                for n, p in model.named_parameters()}

    def maybe_update(self, masks: Masks, model, step: int) -> Masks:
        """Recompute masks on the prune cadence (host-side decision, like
        the reference's ``step % prune_every == 0``)."""
        if step >= self.cfg.start_step and step % self.cfg.prune_every == 0:
            return self.compute(model, step)
        return masks

    def masks_for_resume(self, model, step: int) -> Masks:
        """Reconstruct the active masks when resuming from a checkpoint at
        ``step``: the weights are stored masked (pruned weights are exactly
        zero), the ramp derives from the step, and zero-magnitude weights
        sort below any positive threshold, so recomputing at the last
        cadence point reproduces the mask."""
        step0 = (step // self.cfg.prune_every) * self.cfg.prune_every
        if step0 >= self.cfg.start_step:
            return self.compute(model, step0)
        return self.init_masks(model)

    @staticmethod
    def apply(masks: Masks, model) -> None:
        """Multiply every parameter by its mask, in place."""
        params = dict(model.named_parameters())
        names = list(masks)
        with torch.no_grad():
            torch._foreach_mul_([params[n] for n in names],
                                [masks[n] for n in names])


def make_pruner_from_hp(hp) -> Optional[Pruner]:
    """Build a Pruner from the ``voc_prune_*`` hparams (None when pruning
    is off)."""
    if not hp.get("voc_prune", False):
        return None
    cfg = PruneConfig(
        target_sparsity=hp.get("voc_prune_target_sparsity", 0.9375),
        start_step=hp.get("voc_prune_start", 20_000),
        ramp_steps=hp.get("voc_prune_ramp", 480_000),
        prune_every=hp.get("voc_prune_every", 500),
    )
    return Pruner(cfg)


def measured_sparsity(masks: Masks) -> float:
    """Fraction of zeroed weights across all masked leaves."""
    total = sum(m.numel() for m in masks.values())
    zeros = sum(float((m == 0).sum()) for m in masks.values())
    return zeros / total
