"""The port's matmul floor (``ops/matmul_floor.py``) against the JAX
package's ``tools/kernel_breakdown.py::matmul_only_kernel``.

* At h0 = 0, the JAX kernel run through ``pl.pallas_call(...,
  interpret=True)`` and the port's plain version give the same output:
  zeros.  The JAX kernel zeroes its state and tanh(0 @ W) = 0, so its
  output is zero for any weights; this case checks shapes and the start.
* At a nonzero h0, the port's plain version against a jnp re-expression of
  the same step at full width (H = 512): h within 1e-5 (the plain version
  sums in float64, XLA in float32), and the discarded columns' sum within
  1e-5 of their absolute sum.
* The CPU wrapper runs the plain version without counting a launch and
  rejects what the kernel does not take.

The CUDA kernel itself is tested in ``test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tools import kernel_breakdown
from wavernn_tpu_torch.ops import matmul_floor as mf
from tests.torch_cpu import one_torch_thread  # noqa: F401

H = kernel_breakdown.H


def jax_weights(w: dict):
    return [jnp.asarray(w[k].float().numpy(), jnp.bfloat16)
            for k in mf.WEIGHT_ORDER]


def test_plain_version_matches_pallas_kernel_from_zero():
    B, T = 8, 4
    w = mf.make_floor_weights(0)
    want = pl.pallas_call(
        functools.partial(kernel_breakdown.matmul_only_kernel, T=T),
        out_shape=jax.ShapeDtypeStruct((B, H), jnp.float32),
        scratch_shapes=[pltpu.VMEM((B, H), jnp.float32)],
        interpret=True)(*jax_weights(w))
    h, sink, sink_abs = mf.matmul_floor_reference(w, B, T)
    # both are zero: the state starts at zero and tanh(0 @ W) = 0
    assert h.shape == (B, H) and h.dtype == torch.float32
    np.testing.assert_array_equal(h.numpy(), np.asarray(want))
    assert float(h.abs().max()) == 0.0
    assert float(sink_abs.max()) == 0.0


def jnp_floor(ws, h0, T):
    """The JAX kernel's step, re-expressed in jnp from a given state, with
    the discarded columns summed in numpy float64."""
    w1, w2, w3, w4, wf1, wf2 = ws
    h = jnp.asarray(h0)
    sink = np.zeros(h0.shape[0])
    sink_abs = np.zeros(h0.shape[0])
    for _ in range(T):
        hb = h.astype(jnp.bfloat16)
        g1, g2, g3, g4, f1, f2 = (
            jnp.dot(hb, w, preferred_element_type=jnp.float32)
            for w in (w1, w2, w3, w4, wf1, wf2))
        h = jnp.tanh(g1[:, :H] + g2[:, H:2 * H] + g3[:, 2 * H:] + g4[:, :H]
                     + f1 + f2)
        dropped = np.concatenate(
            [np.asarray(a) for a in (g1[:, H:], g2[:, :H], g2[:, 2 * H:],
                                     g3[:, :2 * H], g4[:, H:])],
            axis=1).astype(np.float64)
        sink += dropped.sum(axis=1)
        sink_abs += np.abs(dropped).sum(axis=1)
    return np.asarray(h), sink, sink_abs


def test_plain_version_matches_jnp_from_nonzero_state():
    B, T = 4, 3
    w = mf.make_floor_weights(1)
    h0 = np.random.default_rng(2).uniform(-1, 1, (B, H)).astype(np.float32)
    want_h, want_sink, want_abs = jnp_floor(jax_weights(w), h0, T)
    h, sink, sink_abs = mf.matmul_floor_reference(
        w, B, T, torch.from_numpy(h0))
    assert sink.dtype == sink_abs.dtype == torch.float64
    assert float(h.abs().max()) > 0.1          # the nonzero start carries
    np.testing.assert_allclose(h.numpy(), want_h, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sink_abs.numpy(), want_abs, rtol=1e-5)
    assert np.all(np.abs(sink.numpy() - want_sink) <= 1e-5 * want_abs)
    assert mf.floor_macs(B, T) == B * T * H * 7168


def test_cpu_wrapper_runs_plain_version_and_checks_inputs():
    B, T = 3, 2
    w = mf.make_floor_weights(3, H=64)
    h0 = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (B, 64)).astype(np.float32))
    n = mf.matmul_floor.launches
    got = mf.matmul_floor(w, B, T, h0)
    assert mf.matmul_floor.launches == n          # CPU: no kernel
    want = mf.matmul_floor_reference(w, B, T, h0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="bfloat16"):
        mf.matmul_floor(dict(w, w2=w["w2"].float()), B, T, h0)
    with pytest.raises(ValueError, match="wf1"):
        mf.matmul_floor(dict(w, wf1=w["w1"]), B, T, h0)
    with pytest.raises(ValueError, match="h0"):
        mf.matmul_floor(w, B, T, h0[:, :32].contiguous())
    with pytest.raises(ValueError, match="h0"):
        mf.matmul_floor(w, B, T, h0.double())
    with pytest.raises(ValueError, match="positive"):
        mf.matmul_floor(w, B, 0, h0)
