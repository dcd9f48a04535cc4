"""The decode kernel's ablations (``cuda_decode.decode_reference(...,
ablate=...)``, the CUDA kernel's plain version) against the Pallas kernel's
``ablate`` knob, run in interpret mode, deterministic, at tiny widths.

The tolerance is the one ``test_torch_decode.py`` holds the plain version
to against the Pallas kernel: the first 64 steps within 1e-3 (here all 16
steps are among them).  ``out_write`` leaves the output unspecified, so
only its shape is checked.  The CUDA kernel's ablations are tested in
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.models.wavernn import WaveRNN as JaxWaveRNN
from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu.ops import pallas_decode
from wavernn_tpu.ops.decode import extract_decode_weights as jax_extract
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig, from_jax_variables
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.ops.decode import extract_decode_weights
from tests.torch_cpu import one_torch_thread  # noqa: F401

KW = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
          res_blocks=2, mode="MOL")
B, T = 2, 16


@pytest.fixture(scope="module")
def tiny():
    """JAX weights, the port's packed weights (int8_hh, as in production)
    and one seeded conditioning, as numpy inputs to both."""
    v = JaxWaveRNN(JaxConfig(**KW)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 275)), jnp.zeros((1, 5, 80)),
        True)
    v = jax.tree_util.tree_map(np.asarray, v)
    cfg = WaveRNNConfig(**KW)
    packed = cuda_decode.pack_weights(
        extract_decode_weights(from_jax_variables(v, cfg, "cpu")),
        cfg.feat_dims, cfg.aux_dims, int8_hh=True)
    rng = np.random.default_rng(0)
    mels_up = rng.uniform(0, 1, (B, T, cfg.feat_dims)).astype(np.float32)
    aux = rng.uniform(0, 1, (B, T, cfg.res_out_dims)).astype(np.float32)
    cond = torch.cat([torch.from_numpy(mels_up), torch.from_numpy(aux)],
                     -1).to(torch.bfloat16)
    return cfg, jax_extract(v["params"]), packed, mels_up, aux, cond


@pytest.mark.parametrize("ablate", [{"gates"}, {"cond_read"}, {"sample"},
                                    {"sample", "gates"}],
                         ids=["gates", "cond_read", "sample", "sample+gates"])
def test_ablated_plain_version_matches_pallas_interpret(tiny, ablate):
    cfg, wj, packed, mels_up, aux, cond = tiny
    ablate = frozenset(ablate)
    want = np.asarray(pallas_decode.decode(
        wj, jnp.asarray(mels_up), jnp.asarray(aux), jax.random.PRNGKey(0),
        mode="MOL", n_classes=cfg.n_classes, deterministic=True,
        interpret=True, int8_hh=True, ablate=ablate))
    got = cuda_decode.decode(packed, cond, T, 0, "MOL", cfg.n_classes, True,
                             ablate=ablate).numpy()
    assert got.shape == want.shape == (B, T)
    assert np.abs(got - want).max() <= 1e-3
    # the ablation changed what the step computes
    full = cuda_decode.decode_reference(packed, cond, T, 0, "MOL",
                                        cfg.n_classes, True).numpy()
    assert np.abs(got - full).max() > 1e-3


def test_out_write_ablation_and_unknown_names(tiny):
    cfg, _, packed, _, _, cond = tiny
    got = cuda_decode.decode(packed, cond, T, 0, "MOL", cfg.n_classes, True,
                             ablate=frozenset({"out_write"}))
    assert got.shape == (B, T) and got.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown ablations"):
        cuda_decode.decode(packed, cond, T, 0, "MOL", cfg.n_classes, True,
                           ablate=frozenset({"dots"}))
    with pytest.raises(ValueError, match="unknown ablations"):
        cuda_decode.decode_reference(packed, cond, T, 0, "MOL",
                                     cfg.n_classes, True, ablate={"gate"})
    with pytest.raises(ValueError, match="rows_per_cta"):
        cuda_decode.decode(packed, cond, T, 0, "MOL", cfg.n_classes, True,
                           rows_per_cta=4)
    assert cuda_decode.ablation_mask({"sample", "gates"}) == 3
