"""Data parallelism over devices (ports ``wavernn_tpu/parallel/``): local
plans for generation and serving, world plans for one-process-per-device
training (``parallel/mesh.py``), and the process group's start-up
(``parallel/distributed.py``)."""

from wavernn_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshPlan,
    make_mesh,
    shard_batch_fn,
    shard_rows,
    world_mesh,
)
