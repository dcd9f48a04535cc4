"""Data and model axes over devices (ports ``wavernn_tpu/parallel/``):
local plans for generation and serving, world plans for one-process-per-
device training (``parallel/mesh.py``), tensor parallelism over the model
axis (``parallel/tensor_parallel.py``), and the process group's start-up
(``parallel/distributed.py``)."""

from wavernn_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshPlan,
    make_mesh,
    shard_batch_fn,
    shard_rows,
    world_mesh,
)
from wavernn_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    make_param_specs,
    shard_params,
)
