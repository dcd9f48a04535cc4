"""PyTorch + CUDA port of the WaveRNN vocoder's copy-synthesis path.

The JAX package ``wavernn_tpu`` is the reference this package is held
against; nothing here imports it, JAX, flax or msgpack.  Importing this
package has no side effects: the CUDA decode kernel is built on its first
launch (``ops/build.py``), and the float32 policy below is applied by the
callers that need it (``ops.decode.Generator``, ``chip_smoke.py``).
"""

import torch


def set_float32_policy() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the MelResNet and upsample convolutions would then
    drift from the JAX reference's float32 conditioning."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
