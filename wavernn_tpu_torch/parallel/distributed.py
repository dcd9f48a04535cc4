"""Multi-process start-up (ports ``wavernn_tpu/parallel/distributed.py``).

The JAX package is single-controller: one process per host sees every
chip, and ``jax.distributed`` joins the hosts.  Training in this package
runs as PyTorch users run it, one process per device (``torchrun
--nproc_per_node=N``), each joined into one ``torch.distributed`` process
group.  :func:`maybe_initialize_distributed` starts that group when the
environment asks for it, so a single-process run never pays for it:

* torchrun's contract: ``WORLD_SIZE`` > 1, with ``RANK``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT``;
* or the JAX package's switch ``WAVERNN_TPU_DISTRIBUTED=1``, with the same
  variables.

The backend is ``"nccl"`` for a CUDA rank and ``"gloo"`` for a CPU rank,
unless the caller names one.  Nothing changes it after a failure: a
group that cannot start raises.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def requested() -> bool:
    """Whether the environment asks for a process group."""
    return (os.environ.get("WAVERNN_TPU_DISTRIBUTED") == "1"
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def default_backend(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def local_rank() -> int:
    """This process's index on its node (torchrun's ``LOCAL_RANK``, else
    ``RANK``, else 0)."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def rank_device(name: str) -> torch.device:
    """The device a rank trains on: ``name`` as given, except that a bare
    ``"cuda"`` in a process group is ``cuda:LOCAL_RANK``, one card per
    rank.  ``cuda`` without CUDA raises."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} asked for, but CUDA is not "
                               "available (use --device cpu to run on the "
                               "CPU)")
        if dev.index is None and dist.is_initialized():
            dev = torch.device("cuda", local_rank())
    return dev


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 device="cuda",
                                 timeout_s: float = 600.0) -> bool:
    """Join the process group the environment describes, once; later calls
    return at once.  ``backend`` defaults to :func:`default_backend` of
    ``device`` (the rank's device, ``"cuda"`` by default).  A CUDA rank
    first takes ``cuda:LOCAL_RANK`` as its current device.  Returns True
    when more than one rank is running."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not requested():
        return False
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"a process group was asked for, but {missing} "
                           "are not set (launch with torchrun, or set "
                           f"{', '.join(_ENV)} and LOCAL_RANK)")
    backend = backend or default_backend(device)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend=backend, init_method="env://",
                            timeout=timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Whether this process writes checkpoints and logs (rank 0)."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()
