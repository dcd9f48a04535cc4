"""int8_gates, the decode kernel's variant with the five big matrices int8
and each operand quantized per row on the fly: its pack and its plain
version (``ops/cuda_decode.py``) against the JAX package, and the pack's
variant marker.  The ``gen_int8`` path that turns it on (``Generator``,
``make_generator``, the CLIs) is in ``tests/test_torch_gen_int8.py``, the
CUDA kernel against its plain version in ``tests/test_torch_cuda.py``.

Tolerances: the packs bit for bit (both quantize in float32 in the same
order); the plain version against the Pallas kernel in interpret mode,
deterministic, B = 4 x T = 128, with the thresholds of
``test_torch_decode.py``'s int8_ff case: the first 64 steps within 1e-3
and 99% of samples within 2e-2 (the int8 sums are exact in both packages;
a float32 difference elsewhere can move an operand across a quantization
boundary or nudge a row's scale, which moves one step and stays inside
them).  The models are seeded port models in JAX layout
(``tests/test_torch_int8_ff.py::small``), so no JAX init compiles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.ops import pallas_decode
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.test_torch_decode import REPO, both_weights, conditioning, unpadded
from tests.test_torch_int8_ff import small
from tests.torch_cpu import one_torch_thread  # noqa: F401

GATES = ("w_hh1", "w_ih2x", "w_hh2", "w_fc1x", "w_fc2x")


@pytest.mark.parametrize("which", ["small_mol", "golden"])
def test_pack_weights_int8_gates_bit_equal(which):
    """The five int8 matrices and their raw column scales equal the Pallas
    pack's (without its lane padding); the pack holds what JAX's does."""
    if which == "golden":
        blob = load_pytree(REPO / "bench_assets" /
                           "wavernn_mol_golden.msgpack")
        cfg = WaveRNNConfig()
        v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    else:
        kw, v = small("MOL")
        cfg = WaveRNNConfig(**kw)
    wj, wt = both_weights(cfg, v)
    n_out_pad = -(-cfg.n_classes // 128) * 128
    pj = pallas_decode.pack_weights(wj, cfg.feat_dims, cfg.aux_dims,
                                    n_out_pad, int8_gates=True)
    pt = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                  int8_gates=True)
    assert set(k for k, t in pt.items() if t is not None) == set(pj)
    for name in GATES:
        q, s = pt[name], pt[name + "_s"]
        assert q.dtype == torch.int8 and s.dtype == torch.float32, name
        np.testing.assert_array_equal(q.numpy(),
                                      unpadded(pj[name], tuple(q.shape)))
        np.testing.assert_array_equal(s.numpy(),
                                      unpadded(pj[name + "_s"], tuple(s.shape)))
    # the conditioning and output matrices are the default pack's
    pb = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims)
    for name in ("w_aux", "w_Im1", "w_Im", "w_fc3", "b1"):
        assert torch.equal(pt[name], pb[name]), name


def test_int8_gates_pack_is_not_taken_for_int8_ff():
    """The variant is read from the pack's scale names, not from the
    dtypes (an int8_gates pack has int8 recurrent and feed-forward
    matrices, as int8_hh + int8_ff has): the markers, the plain version,
    the wrapper's refusals and its counters on the CPU."""
    kw, v = small("MOL")
    cfg = WaveRNNConfig(**kw)
    _, wt = both_weights(cfg, v)
    g = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                 int8_gates=True)
    ff = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                  int8_ff=True,
                                  ff_scales=torch.tensor([3.0, 4.0, 5.0]))
    assert g["w_hh1"].dtype == g["w_ih2x"].dtype == torch.int8
    assert (cuda_decode.is_int8_gates(g), cuda_decode.is_int8_ff(g),
            cuda_decode.is_int8_hh(g)) == (True, False, False)
    assert (cuda_decode.is_int8_gates(ff), cuda_decode.is_int8_ff(ff),
            cuda_decode.is_int8_hh(ff)) == (False, True, True)
    assert cuda_decode.variant(g) == "int8_gates"
    assert cuda_decode.variant(ff) == "int8_hh+int8_ff"
    with pytest.raises(ValueError, match="exclusive"):
        cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                 int8_gates=True, int8_ff=True,
                                 ff_scales=torch.ones(3))
    mels_up, aux = conditioning(cfg, 2, 32)
    cond = torch.cat([torch.from_numpy(mels_up), torch.from_numpy(aux)],
                     -1).to(torch.bfloat16)
    args = (cond, 32, 0, "MOL", cfg.n_classes, True)
    for bad in (dict(rows_per_cta=2), dict(ablate=frozenset({"sample"}))):
        with pytest.raises(ValueError, match="int8_gates"):
            cuda_decode.decode(g, *args, **bad)
    n = (cuda_decode.decode.launches, cuda_decode.decode.launches_int8_ff,
         cuda_decode.decode.launches_int8_gates)
    got = cuda_decode.decode(g, *args)
    assert (cuda_decode.decode.launches, cuda_decode.decode.launches_int8_ff,
            cuda_decode.decode.launches_int8_gates) == n   # the CPU: none
    # on-the-fly quantization, not int8_ff's fixed scales: the two differ
    assert not torch.equal(got, cuda_decode.decode(ff, *args))
    torch.testing.assert_close(got, cuda_decode.decode_reference(g, *args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_decode_reference_int8_gates_matches_pallas_interpret(mode):
    kw, v = small(mode)
    cfg = WaveRNNConfig(**kw)
    wj, wt = both_weights(cfg, v)
    B, T = 4, 128
    mels_up, aux = conditioning(cfg, B, T)
    want = np.asarray(pallas_decode.decode(
        wj, jnp.asarray(mels_up), jnp.asarray(aux), jax.random.PRNGKey(0),
        mode=mode, n_classes=cfg.n_classes, deterministic=True,
        interpret=True, int8_gates=True))
    packed = cuda_decode.pack_weights(wt, cfg.feat_dims, cfg.aux_dims,
                                      int8_gates=True)
    cond = torch.cat([torch.from_numpy(mels_up), torch.from_numpy(aux)],
                     -1).to(torch.bfloat16)
    got = cuda_decode.decode(packed, cond, T, seed=0, mode=mode,
                             n_classes=cfg.n_classes,
                             deterministic=True).numpy()
    assert got.shape == want.shape == (B, T)
    d = np.abs(got - want)
    assert d[:, :64].max() <= 1e-3, d[:, :64].max()
    assert np.mean(d <= 2e-2) >= 0.99, np.mean(d <= 2e-2)
    assert np.all(np.abs(got) <= 1.0)
