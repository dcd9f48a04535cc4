"""Train state and optimizer (ports ``wavernn_tpu/training/state.py``).

The JAX package trains with optax: ``chain(clip_by_global_norm(clip),
inject_hyperparams(adam)(learning_rate=lr))``.  :class:`Adam` is that
optimizer written out in torch, step for step:

  * the global norm is taken over every parameter's gradient (BatchNorm
    scale and bias included), before clipping, and is what a step returns;
    under tensor parallelism (``parallel.tensor_parallel``) it is
    ``sqrt(sum over the model group of |sharded|^2 + |replicated|^2)``,
    the single device's norm, and the moments take the shards' shapes;
  * gradients are scaled by ``clip / norm`` only when ``norm >= clip``
    (``torch.nn.utils.clip_grad_norm_`` would divide by ``norm + 1e-6`` on
    every step);
  * ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g^2``, bias-corrected
    by ``1 - b^count``, and the update is ``-lr * mu_hat / (sqrt(nu_hat +
    eps_root) + eps)``.

The hyperparameters are float32 values, as ``inject_hyperparams`` keeps
them, and the learning rate can change without losing the moments
(:func:`set_learning_rate`, the reference's ``param_group['lr'] = lr``).

:class:`AdamState` converts to and from the layout that
``flax.serialization.to_state_dict`` gives the optax state
(:meth:`AdamState.state_dict`), so an optimizer file moves between the two
packages as it is.  Each model brings its own map to the flax tree
(:func:`layout_of`): the WaveRNN vocoder's and Tacotron's.  The step
counter lives on the host: nothing in a step waits for the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from wavernn_tpu_torch.models import tacotron, wavernn
from wavernn_tpu_torch.parallel.tensor_parallel import (
    full_tensors, local_tensors, model_group_sum, sharded_parameters,
)

_F32 = np.float32


@dataclass(frozen=True)
class FlaxLayout:
    """How a model's tensors map to the JAX package's flax trees:
    ``to_tree(tensors, model)`` / ``from_tree(tree, model)`` for a
    per-parameter dict keyed by plain names (the parameters or an Adam
    moment) and the ``params`` tree, ``to_variables(model)`` /
    ``load_variables(model, variables)`` for ``{"params",
    "batch_stats"}``, and ``params(model)``: every parameter as (torch
    name, flax path, move)."""

    to_tree: Callable
    from_tree: Callable
    to_variables: Callable
    load_variables: Callable
    params: Callable


_LAYOUTS = {
    wavernn.WaveRNN: FlaxLayout(
        lambda t, m: wavernn.to_jax_tree(t, m.cfg),
        lambda t, m: wavernn.from_jax_tree(t, m.cfg),
        wavernn.to_jax_variables, wavernn.load_jax_variables,
        lambda m: wavernn.param_layout(m.cfg)),
    tacotron.Tacotron: FlaxLayout(
        tacotron.to_jax_tree, tacotron.from_jax_tree,
        tacotron.to_jax_variables, tacotron.load_jax_variables,
        tacotron.param_layout),
}


def layout_of(model: nn.Module) -> FlaxLayout:
    """The flax tree map of a WaveRNN or a Tacotron."""
    return _LAYOUTS[type(model)]


@dataclass
class AdamState:
    """Adam's moments (keyed by the model's parameter names), its step
    count and its injected hyperparameters (float32 values).  ``chained``
    says whether the state sits behind optax's clip transform, which
    decides the saved layout."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    hyperparams: Dict[str, float]
    chained: bool

    @property
    def learning_rate(self) -> float:
        return self.hyperparams["learning_rate"]

    def state_dict(self, model: nn.Module) -> dict:
        """The flax state dict of the optax state: ``{"0": {}, "1":
        inject}`` behind a clip, else ``inject``, where inject is
        ``{count, hyperparams, hyperparams_states, inner_state: {"0":
        {count, mu, nu}, "1": {}}}`` with mu and nu in the flax
        ``params`` layout of ``model``, the moments of a parameter
        sharded over the model axis gathered to their full shape (every
        rank of the model group calls this)."""
        to_tree = lambda t, m: layout_of(m).to_tree(full_tensors(t, m), m)
        count = np.asarray(self.count, np.int32)
        inject = {
            "count": count,
            "hyperparams": {k: np.asarray(v, _F32) for k, v in
                            sorted(self.hyperparams.items())},
            "hyperparams_states": {},
            "inner_state": {
                "0": {"count": count.copy(),
                      "mu": to_tree(self.mu, model),
                      "nu": to_tree(self.nu, model)},
                "1": {},
            },
        }
        return {"0": {}, "1": inject} if self.chained else inject

    @classmethod
    def from_state_dict(cls, tree: dict, model: nn.Module,
                        chained: bool) -> "AdamState":
        """Read :meth:`state_dict`'s layout (as either package writes it)
        onto ``model``'s device, each moment of a sharded parameter cut to
        this rank's slice.  Raises KeyError on another layout."""
        inject = tree["1"] if chained else tree
        if chained and tree["0"] != {}:
            raise KeyError("unexpected clip state in the optimizer file")
        adam = inject["inner_state"]["0"]
        dev = next(model.parameters()).device
        from_tree = layout_of(model).from_tree
        moment = lambda t: {k: v.to(dev) for k, v in local_tensors(
            {k: torch.from_numpy(v) for k, v in from_tree(t, model).items()},
            model).items()}
        return cls(count=int(adam["count"]), mu=moment(adam["mu"]),
                   nu=moment(adam["nu"]),
                   hyperparams={k: float(_F32(v)) for k, v in
                                inject["hyperparams"].items()},
                   chained=chained)


class Adam:
    """optax's ``chain(clip_by_global_norm(clip), inject_hyperparams(adam))``
    (``clip=None``: the bare ``inject_hyperparams(adam)``) over a model's
    parameters."""

    def __init__(self, lr: float, clip: Optional[float] = None):
        self.clip = clip
        # optax.adam's defaults, injected beside the learning rate
        self.hyperparams = {"learning_rate": lr, "b1": 0.9, "b2": 0.999,
                            "eps": 1e-8, "eps_root": 0.0}

    def init(self, model: nn.Module) -> AdamState:
        zeros = lambda: {n: torch.zeros_like(p, memory_format=
                                             torch.contiguous_format)
                         for n, p in model.named_parameters()}
        return AdamState(count=0, mu=zeros(), nu=zeros(),
                         hyperparams={k: float(_F32(v)) for k, v in
                                      self.hyperparams.items()},
                         chained=self.clip is not None)

    def step(self, model: nn.Module, state: AdamState) -> torch.Tensor:
        """Apply one update from the gradients in ``model``'s ``.grad``s
        (then cleared) and advance ``state``.  Returns the global gradient
        norm before clipping, as a 0-d tensor on the device (no sync)."""
        names = list(state.mu)
        params = dict(model.named_parameters())
        ps = [params[n] for n in names]
        gs = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in ps]
        norms = torch.stack(torch._foreach_norm(gs))
        shards = sharded_parameters(model)
        if shards:
            # a sharded gradient's norm is its slices' over the model group
            sharded = torch.tensor([n in shards for n in names],
                                   device=norms.device)
            sq = norms.square()
            norm = (model_group_sum(sq[sharded].sum(),
                                    next(iter(shards.values())).plan)
                    + sq[~sharded].sum()).sqrt()
        else:
            norm = torch.linalg.vector_norm(norms)
        if self.clip is not None:
            # select(norm < clip, g, (g / norm) * clip), exactly: a divide
            # and a multiply by 1 leave g as it is
            keep = norm < self.clip
            one = torch.ones((), device=norm.device)
            gs = torch._foreach_div(gs, torch.where(keep, one, norm))
            torch._foreach_mul_(gs, torch.where(keep, one, one * self.clip))
        h = {k: _F32(v) for k, v in state.hyperparams.items()}
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        with torch.no_grad():
            torch._foreach_mul_(mu, float(h["b1"]))
            torch._foreach_add_(mu, gs, alpha=float(_F32(1) - h["b1"]))
            torch._foreach_mul_(nu, float(h["b2"]))
            torch._foreach_addcmul_(nu, gs, gs, value=float(_F32(1) - h["b2"]))
            count = state.count + 1
            bc1 = _F32(1) - np.power(h["b1"], _F32(count), dtype=_F32)
            bc2 = _F32(1) - np.power(h["b2"], _F32(count), dtype=_F32)
            m_hat = torch._foreach_div(mu, float(bc1))
            v_hat = torch._foreach_div(nu, float(bc2))
            torch._foreach_add_(v_hat, float(h["eps_root"]))
            torch._foreach_sqrt_(v_hat)
            torch._foreach_add_(v_hat, float(h["eps"]))
            torch._foreach_div_(m_hat, v_hat)
            torch._foreach_mul_(m_hat, -float(h["learning_rate"]))
            torch._foreach_add_(ps, m_hat)
        for p in ps:
            p.grad = None
        state.count = count
        return norm


@dataclass
class TrainState:
    """The model (a WaveRNN or a Tacotron: parameters and BatchNorm
    statistics), the optimizer state and the step counter (a host int)."""

    model: nn.Module
    opt_state: AdamState
    step: int = 0

    def get_step(self) -> int:
        return self.step

    # the two trees of a checkpoint pair (``utils.checkpoints``)

    def weights_tree(self) -> dict:
        """The JAX package's weights file (its ``_model_blob``): ``params``
        and ``batch_stats`` in the flax layout, and the step as a 0-d
        array; no optimizer data.  Parameters sharded over the model axis
        are gathered to their full shape (every rank of the model group
        calls this), so the file is the one an unsharded run writes."""
        v = layout_of(self.model).to_variables(self.model)
        return {"params": v["params"], "batch_stats": v["batch_stats"],
                "step": np.asarray(self.step, np.int32)}

    def load_weights_tree(self, tree: dict) -> None:
        """Parameters, BatchNorm statistics and step from a weights file."""
        layout_of(self.model).load_variables(self.model, tree)
        self.step = int(np.asarray(tree["step"]))

    def optim_tree(self) -> dict:
        return {"opt_state": self.opt_state.state_dict(self.model)}

    def load_optim_tree(self, tree: dict) -> None:
        """The optimizer file, as either package writes it, onto this
        state's layout (clipped or not)."""
        self.opt_state = AdamState.from_state_dict(
            tree["opt_state"], self.model, self.opt_state.chained)


def new_train_state(model: nn.Module, optimizer: Adam) -> TrainState:
    return TrainState(model=model, opt_state=optimizer.init(model), step=0)


def make_optimizer(lr: float, clip_grad_norm: Optional[float]) -> Adam:
    """Adam + optional global-norm clipping (ref: train_wavernn.py:127-131)."""
    return Adam(lr, clip_grad_norm)


def set_learning_rate(opt_state: AdamState, lr: float) -> AdamState:
    """Set the injected learning rate (in place), keeping the moments."""
    opt_state.hyperparams["learning_rate"] = float(_F32(lr))
    return opt_state
