"""Data and model axes over devices (ports ``wavernn_tpu/parallel/
mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` of shape (data, model)
and lets XLA insert the collectives.  Here a :class:`MeshPlan` is one of
two kinds, as PyTorch's idiom differs by path:

* a **local** plan: one process drives several devices.  Generation and
  serving use it (``Generator(mesh=)``, ``TTSGenerator(mesh=)``): the HTTP
  daemon is one process whose scheduler thread owns the cards.  Its
  devices are laid out row-major as (n_data, n_model), as JAX's
  ``np.asarray(devices).reshape(n_data, n_model)``; :func:`shard_rows`
  splits a launch's rows over the data axis and runs shard k on the first
  device of row k (JAX's ``shard_map`` with ``P("data")`` repeats each
  shard along its model row: the result is the same).  A device may
  repeat: ``["cuda:0", "cuda:0"]`` hosts two shards on one card, and the
  tests shard over ``["cpu"] * 4``, as the JAX tests shard over 8 virtual
  CPU devices.
* a **world** plan: one process per device in a ``torch.distributed``
  process group (``parallel/distributed.py``).  The trainers use it: their
  steps are bound by the host issuing launches, so one thread could not
  feed several cards.  Rank ``d * n_model + m`` sits at data index d and
  model index m.  :func:`shard_batch_fn` slices each global batch to the
  rows of the rank's data index, and :func:`all_reduce_mean_`,
  :func:`mean_over` and :func:`all_reduce_sum` (the gradients' average,
  the loss, BatchNorm's statistics) reduce over the **data group**, the
  ranks of one model index: the ranks of one data index hold the same
  rows, so a sum over the whole world would count each row ``n_model``
  times.

The model axis carries tensor parallelism when a caller asks for it
(``parallel/tensor_parallel.py``: ``make_param_specs``, ``shard_params``).
Without that, as in every CLI, the parameters are replicated along it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from wavernn_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class MeshPlan:
    """A (data, model) layout.  ``devices``: a local plan's devices,
    row-major over (n_data, n_model) (the first holds a launch's inputs
    and outputs); a world plan's one device, this rank's.  ``rank`` is
    this process's rank in the world (0 for a local plan); ``group`` a
    world plan's data group (the ranks of this rank's model index, which
    every reduction runs over) and ``model_group`` its model group (the
    ranks of its data index, which tensor parallelism gathers over; None
    when ``n_model`` is 1)."""

    n_data: int
    devices: Tuple[torch.device, ...]
    world: bool = False
    rank: int = 0
    group: Optional[object] = None
    n_model: int = 1
    model_group: Optional[object] = None

    @property
    def data_rank(self) -> int:
        """This rank's index on the data axis: the rows it trains on."""
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        """This rank's index on the model axis: the shard it holds."""
        return self.rank % self.n_model

    @property
    def device(self) -> torch.device:
        """Where inputs and outputs live: a local plan's first device, a
        world plan's own."""
        return self.devices[0]

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """A local plan's device of each data shard: the first of each
        model row."""
        return self.devices[::self.n_model]

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices))

    def describe(self) -> str:
        kind = (f"world, rank {self.rank} on {self.device}" if self.world
                else "local: " + ", ".join(str(d) for d in self.devices))
        return f"data={self.n_data} model={self.n_model} ({kind})"


def concrete_device(d) -> torch.device:
    """A concrete device, as a tensor's ``.device`` names it: ``cuda``
    takes the current index, and CUDA must exist."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d!r} asked for, but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _axes(shape: Optional[Dict[str, int]]) -> Tuple[Optional[int], int]:
    shape = dict(shape or {})
    unknown = set(shape) - {"data", "model"}
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the axes "
                         "are 'data' and 'model'")
    return ((int(shape["data"]) if "data" in shape else None),
            int(shape.get("model", 1)))


def _split(shape, n: int, what: str) -> Tuple[int, int]:
    """(n_data, n_model) of ``shape`` over ``n`` devices or ranks: the
    data axis takes what the model axis leaves when ``shape`` does not
    name it; a product other than ``n`` raises ``ValueError``."""
    n_data, n_model = _axes(shape)
    if n_data is None:
        n_data = n // n_model if n_model > 0 else 0
    if n_model < 1 or n_data < 1 or n_data * n_model != n:
        raise ValueError(f"mesh shape {shape} does not match {what} {n}")
    return n_data, n_model


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> MeshPlan:
    """Build a (data, model) plan.

    Inside a process group of more than one rank this is
    :func:`world_mesh`.  Otherwise it is a local plan over ``devices``
    (default: every visible CUDA device; without one it raises, it never
    takes the CPU unasked), laid out row-major as (n_data, n_model).
    ``shape``, e.g. ``{"data": 4, "model": 2}``, must match the device
    count (``ValueError``); without it every device is on the data
    axis."""
    _axes(shape)
    if distributed.world_size() > 1:
        return world_mesh(shape, devices[0] if devices else None)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=[...] (e.g. ['cpu'] * n) to shard "
                               "over others")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(concrete_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    n_data, n_model = _split(shape, len(devices), "device count")
    return MeshPlan(n_data=n_data, devices=devices, n_model=n_model)


def world_mesh(shape: Optional[Dict[str, int]] = None,
               device=None) -> MeshPlan:
    """The plan of this rank in the initialized process group, of any
    world size (1 included): ``n_data * n_model`` = world size, the data
    axis taking every rank without ``shape``.  ``device`` is this rank's;
    by default ``cuda:LOCAL_RANK`` under NCCL and the CPU under gloo.
    With a model axis every rank builds the data and model groups
    (``dist.new_group``, in the same order on every rank)."""
    if not dist.is_initialized():
        raise RuntimeError("world_mesh needs an initialized process group "
                           "(parallel.distributed."
                           "maybe_initialize_distributed)")
    world = dist.get_world_size()
    n_data, n_model = _split(shape, world, "the world size")
    if device is None:
        device = (torch.device("cuda", distributed.local_rank())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    rank = dist.get_rank()
    group, model_group = dist.group.WORLD, None
    if n_model > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if rank % n_model == m:
                group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if rank // n_model == d:
                model_group = g
    return MeshPlan(n_data=n_data, devices=(concrete_device(device),),
                    world=True, rank=rank, group=group, n_model=n_model,
                    model_group=model_group)


def check_plan(plan, world: bool, user: str) -> MeshPlan:
    """``plan`` if it is a :class:`MeshPlan` of the kind ``user`` takes,
    else ``ValueError`` naming the right launcher."""
    if not isinstance(plan, MeshPlan):
        raise ValueError(f"{user} takes a parallel.mesh.MeshPlan, got "
                         f"{type(plan).__name__}")
    if plan.world != world:
        if world:
            raise ValueError(
                f"{user} takes a world plan (one process per device: launch "
                "with torchrun and build it with make_mesh inside the "
                f"process group); got a local plan over {plan.n_data} "
                "devices")
        raise ValueError(
            f"{user} takes a local plan (one process over several devices: "
            "make_mesh(devices=...) outside a process group); got the world "
            f"plan of rank {plan.rank}")
    return plan


class ShardBatch:
    """:func:`shard_batch_fn`'s callable: ``place(*arrays)`` -> this rank's
    rows of each global batch array, as tensors on its device."""

    def __init__(self, plan: MeshPlan):
        self.plan = check_plan(plan, True, "shard_batch_fn")

    def __call__(self, *arrays) -> tuple:
        p = self.plan
        out = []
        for a in arrays:
            n = a.shape[0]
            if n % p.n_data:
                raise ValueError(f"batch size {n} must be divisible by the "
                                 f"data-parallel degree {p.n_data}")
            b = n // p.n_data
            rows = a[p.data_rank * b:(p.data_rank + 1) * b]
            if isinstance(rows, np.ndarray):
                rows = torch.from_numpy(np.ascontiguousarray(rows))
            out.append(rows.to(p.device, non_blocking=True))
        return tuple(out)


def shard_batch_fn(plan: MeshPlan) -> ShardBatch:
    """A function that takes numpy or tensor *global* batch arrays and
    returns this rank's rows of each on this rank's device (the rank of
    data index d takes rows ``[d*b, (d+1)*b)``, b = batch / n_data).  A batch size that is not
    a multiple of ``n_data`` raises ``ValueError``, as the reference's
    DataParallel demands (ref: train_wavernn.py:45-46).  Takes a world
    plan; the trainers read it from ``place.plan``."""
    return ShardBatch(plan)


def shard_rows(plan: MeshPlan, fn: Callable, *xs: torch.Tensor):
    """Run ``fn`` once per shard of a local plan: the rows-first tensors
    ``xs`` are split evenly over the data axis (shard k: rows ``[k*b,
    (k+1)*b)`` on ``data_devices[k]``, the first device of model row k) and ``fn(*shards, row0)`` gets each
    shard's global row offset ``row0 = k*b``.  Every shard is launched
    before any is waited on (the copies and launches queue on each
    device's current stream), and the results (rows-first tensors) are
    gathered back to ``devices[0]`` in row order.
    The counterpart of the JAX package's ``shard_folds_decode`` and
    ``shard_cond_decode``."""
    check_plan(plan, False, "shard_rows")
    B = xs[0].shape[0]
    if B % plan.n_data or any(x.shape[0] != B for x in xs):
        raise ValueError(f"{[x.shape[0] for x in xs]} rows do not split "
                         f"evenly over {plan.n_data} shards")
    b = B // plan.n_data
    outs = [fn(*(x[k * b:(k + 1) * b].to(dev, non_blocking=True)
                 for x in xs), k * b)
            for k, dev in enumerate(plan.data_devices)]
    return torch.cat([o.to(plan.device, non_blocking=True)
                      for o in outs])


# -- collectives of a world plan ----------------------------------------

def _all_reduce_(t: torch.Tensor, plan: MeshPlan,
                 group: Optional[object] = None) -> torch.Tensor:
    """Sum ``t`` over the data group (or ``group``) in place.  gloo takes
    host tensors here: a CUDA tensor is copied to the host, reduced and
    copied back, by design of this function (the backend is never
    switched)."""
    group = plan.group if group is None else group
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the data group of x; the gradient of x is the sum over
    the group of the gradients of y, since every rank's loss reads y."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _all_reduce_(x.clone(), plan)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.plan), None


def all_reduce_sum(x: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """The sum of ``x`` over the data group of a world plan,
    differentiable."""
    return _AllReduceSum.apply(x, plan)


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     plan: MeshPlan) -> None:
    """Average tensors over the data group in place, in one flat
    all-reduce (a sum, then a division by ``n_data``)."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce_(flat, plan).div_(plan.n_data)
    o = 0
    for t in tensors:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()


def mean_over(x: torch.Tensor, plan: Optional[MeshPlan]) -> torch.Tensor:
    """A detached tensor's mean over the data group (itself without a
    plan)."""
    if plan is None:
        return x
    return _all_reduce_(x.detach().clone(), plan).div_(plan.n_data)


def average_gradients_(model: torch.nn.Module, plan: MeshPlan) -> None:
    """Average every parameter's gradient over the data group (a missing
    one counts as zeros, so that every rank reduces the same layout)."""
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_mean_([p.grad for p in params], plan)


def add_mesh_args(parser) -> None:
    """The generation CLIs' ``--mesh`` and ``--mesh_devices``."""
    parser.add_argument("--mesh", "-m", action="store_true",
                        help="shard the vocoder's fold rows over a device "
                             "mesh (hp.mesh_shape when set; every visible "
                             "CUDA device unless --mesh_devices)")
    parser.add_argument("--mesh_devices", metavar="DEVICES",
                        help="comma-separated mesh devices, e.g. "
                             "cuda:0,cuda:1 or cuda:0,cuda:0 (two shards "
                             "on one card) or cpu,cpu")


def mesh_from_args(args, shape: Optional[Dict[str, int]]
                   ) -> Optional[MeshPlan]:
    """The local plan a CLI's ``--mesh`` asks for (None without it),
    printed; ``--mesh_devices`` without ``--mesh`` raises."""
    if not args.mesh:
        if args.mesh_devices:
            raise ValueError("--mesh_devices needs --mesh")
        return None
    devices = args.mesh_devices.split(",") if args.mesh_devices else None
    plan = make_mesh(shape, devices)
    print(f"Decode mesh: {plan.describe()}")
    return plan
