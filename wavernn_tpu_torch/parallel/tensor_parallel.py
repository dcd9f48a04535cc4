"""Tensor parallelism over the model axis of a world plan (ports
``make_param_specs`` and ``shard_params(tensor_parallel=True)`` of
``wavernn_tpu/parallel/mesh.py``).

JAX's rule, applied to each leaf of the model's flax ``params`` tree:
gate-blocked recurrent matrices (``w_ih``/``w_hh``, flax (in, G*H)) and
Dense kernels (flax (in, out)) shard their output dimension over
``model``; a 1-D bias shards only when a sibling matrix of the same flax
module shards, so that BatchNorm ``bias`` (whose sibling is ``scale``)
stays replicated beside its scale, and conv kernels (3-D) and their biases
stay replicated too.  A leaf that does not tile evenly over ``n_model`` is
replicated.  :func:`make_param_specs` reads the flax path and shape of
each parameter from the weight converters' layouts (never from torch
names: ``nn.Embedding``'s and ``FlaxBatchNorm``'s ``weight``/``bias``
look like a matrix and its bias, but JAX replicates ``embedding``,
``scale`` and the BatchNorm ``bias``) and maps the sharded flax dim
through the move: ``transpose`` puts flax dim 1 on torch dim 0, ``copy``
keeps it.

:func:`shard_params` keeps on each rank its contiguous slice of every
sharded parameter (model rank m holds ``[m*n/k, (m+1)*n/k)``, as
``P(None, "model")`` places it), registered through
``torch.nn.utils.parametrize``: reading the parameter all-gathers the
slices over the model group into the full tensor, the all-gather XLA
inserts for a replicated consumer of a sharded weight.  The gather's
backward returns this rank's slice of the full gradient and does not
reduce-scatter: every rank of a model group computes the same full
gradient from the same rows, so a sum would multiply it by ``n_model``.
The models' forward code is unchanged; a train step runs its forward
inside :func:`gathered`, so that a time-step loop gathers once per step,
not once per time step.  Compute is not split over the model axis: each
rank runs the whole forward on its data rows.

Under gloo a CUDA tensor is gathered through the host, as
``parallel.mesh._all_reduce_`` reduces one.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from wavernn_tpu_torch.parallel.mesh import MeshPlan, _all_reduce_, check_plan

_MATRIX_NAMES = ("w_ih", "w_hh", "kernel")
_BIAS_FOR = {"w_ih": ("b_ih",), "w_hh": ("b_hh",), "kernel": ("bias",)}

# (torch name, flax path under ``params``, move, torch shape)
Leaf = Tuple[str, Tuple[str, ...], str, Tuple[int, ...]]


def specs_from_layout(leaves: Sequence[Leaf],
                      n_model: int) -> Dict[str, Optional[int]]:
    """JAX's sharding rule over a model's leaves: ``{torch name: the torch
    dim sharded over the model axis, or None}``."""
    nodes: Dict[tuple, Dict[str, tuple]] = {}
    for name, path, move, shape in leaves:
        flax_shape = tuple(shape)[::-1] if move in ("transpose", "conv") \
            else tuple(shape)
        nodes.setdefault(tuple(path[:-1]), {})[path[-1]] = (name, move,
                                                            flax_shape)
    flax_dim: Dict[str, Optional[int]] = {}
    moves: Dict[str, str] = {}
    for node in nodes.values():
        biases = set()
        for leaf, (name, move, shape) in node.items():
            moves[name] = move
            flax_dim[name] = None
            if (leaf in _MATRIX_NAMES and len(shape) == 2
                    and shape[1] % n_model == 0):
                flax_dim[name] = 1
                biases.update(_BIAS_FOR[leaf])
        for leaf, (name, move, shape) in node.items():
            if leaf in biases and len(shape) == 1 and shape[0] % n_model == 0:
                flax_dim[name] = 0
    return {name: None if d is None
            else 1 - d if moves[name] == "transpose" else d
            for name, d in flax_dim.items()}


def make_param_specs(model: nn.Module,
                     n_model: int) -> Dict[str, Optional[int]]:
    """The tensor-parallel layout of a WaveRNN or a Tacotron: ``{torch
    parameter name: the dim sharded over the model axis, or None}``, JAX's
    ``make_param_specs`` mapped through the weight converters' layouts."""
    from wavernn_tpu_torch.training.state import layout_of

    if sharded_parameters(model):
        raise ValueError("make_param_specs takes an unsharded model")
    params = dict(model.named_parameters())
    leaves = [(name, path, move, tuple(params[name].shape))
              for name, path, move in layout_of(model).params(model)]
    return specs_from_layout(leaves, n_model)


# -- the gather ----------------------------------------------------------

def _all_gather(shard: torch.Tensor, plan: MeshPlan, dim: int
                ) -> torch.Tensor:
    """The model group's slices of a tensor, concatenated on ``dim`` in
    model-rank order."""
    src = shard.detach().contiguous()
    via_host = src.is_cuda and dist.get_backend(plan.model_group) == "gloo"
    if via_host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(plan.n_model)]
    dist.all_gather(parts, src, group=plan.model_group)
    full = torch.cat(parts, dim)
    return full.to(shard.device) if via_host else full


class _GatherShards(torch.autograd.Function):
    """y = the full tensor; the gradient of this rank's slice is its slice
    of y's gradient (every rank of the model group holds the same full
    gradient)."""

    @staticmethod
    def forward(ctx, shard, plan, dim):
        ctx.plan, ctx.dim, ctx.size = plan, dim, shard.shape[dim]
        return _all_gather(shard, plan, dim)

    @staticmethod
    def backward(ctx, g):
        start = ctx.plan.model_rank * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


class GatherShards(nn.Module):
    """The parametrization of a sharded parameter: ``original`` is this
    rank's slice on ``dim``; the parameter read is the full tensor."""

    def __init__(self, plan: MeshPlan, dim: int, full_size: int):
        super().__init__()
        self.plan, self.dim = plan, dim
        self.size = full_size // plan.n_model

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _GatherShards.apply(shard, self.plan, self.dim)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return self.shard_of(full)

    def shard_of(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full tensor."""
        return full.narrow(self.dim, self.plan.model_rank * self.size,
                           self.size).clone()


def shard_params(plan: MeshPlan, model: nn.Module,
                 tensor_parallel: bool = True) -> nn.Module:
    """Shard ``model``'s parameters over the model axis of the world plan
    ``plan`` in place (:func:`make_param_specs`; replicated leaves stay as
    they are) and return it.  With ``tensor_parallel=False`` or one model
    rank the model is left as it is.  Build the optimizer's state after
    this: its moments take the shards' shapes."""
    check_plan(plan, True, "shard_params")
    if not tensor_parallel or plan.n_model == 1:
        return model
    for name, dim in make_param_specs(model, plan.n_model).items():
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        full = getattr(module, leaf)
        parametrize.register_parametrization(
            module, leaf, GatherShards(plan, dim, full.shape[dim]),
            unsafe=True)
    return model


def gathered(model: nn.Module):
    """A block in which each sharded parameter is gathered once, at its
    first read (``parametrize.cached``); a no-op for an unsharded model."""
    return (parametrize.cached() if sharded_parameters(model)
            else contextlib.nullcontext())


# -- names and full tensors ---------------------------------------------

def plain_name(name: str) -> str:
    """A parameter's name as the unsharded model has it
    (``a.parametrizations.kernel.original`` -> ``a.kernel``)."""
    return (name.replace(".parametrizations.", ".")
            .replace("parametrizations.", "").removesuffix(".original"))


def sharded_parameters(model: nn.Module) -> Dict[str, GatherShards]:
    """``{parameter name (as named_parameters gives it): its gather}`` of
    every sharded parameter; empty for an unsharded model."""
    out = {}
    for name, m in _own_modules(model):
        if parametrize.is_parametrized(m):
            for leaf, plist in m.parametrizations.items():
                if isinstance(plist[0], GatherShards):
                    out[_join(name, f"parametrizations.{leaf}.original")] = \
                        plist[0]
    return out


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _own_modules(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """``named_modules`` without the parametrization containers."""
    for name, m in model.named_modules():
        if "parametrizations" not in name.split("."):
            yield name, m


def own_parameter_names(m: nn.Module) -> List[str]:
    """The parameters a module holds itself, by their plain names, the
    parametrized ones included."""
    names = [p for p, _ in m.named_parameters(recurse=False)]
    if parametrize.is_parametrized(m):
        names += list(m.parametrizations)
    return names


def full_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{plain name: the full parameter}``: ``dict(named_parameters())``
    of an unsharded model; a sharded one's are gathered (a collective:
    every rank of the model group calls it)."""
    out = {}
    for name, m in _own_modules(model):
        for p in own_parameter_names(m):
            out[_join(name, p)] = getattr(m, p)
    return out


def full_tensors(tensors: Mapping[str, torch.Tensor],
                 model: nn.Module) -> Dict[str, torch.Tensor]:
    """Per-parameter tensors keyed by ``model``'s parameter names (the
    parameters or an Adam moment) -> keyed by plain names, each sharded
    one gathered to its full shape (a collective)."""
    shards = sharded_parameters(model)
    out = {}
    for name, t in tensors.items():
        g = shards.get(name)
        out[plain_name(name)] = (t if g is None
                                 else _all_gather(t, g.plan, g.dim))
    return out


def local_tensors(tensors: Mapping[str, torch.Tensor],
                  model: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`full_tensors`: plain-named full tensors ->
    keyed by ``model``'s names, each sharded one cut to this rank's
    slice.  Keys that name no sharded parameter pass as they are."""
    out = dict(tensors)
    for name, g in sharded_parameters(model).items():
        out[name] = g.shard_of(torch.as_tensor(out.pop(plain_name(name))))
    return out


def model_group_sum(x: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """The sum of a detached tensor over the model group."""
    return _all_reduce_(x.detach().clone(), plan, plan.model_group)
