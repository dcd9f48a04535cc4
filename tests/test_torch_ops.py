"""The port's decode primitives (``ops/rnn.py``, ``ops/mol.py``,
``ops/fold.py``) against the JAX package's, on the same numpy inputs.

The GRU step and the MOL draw run in float32 on both sides and differ only
in the order of the matmul sums: 1e-5 absolute.  The fold gather moves
the same values: exact.  The crossfade envelopes come from
``torch.linspace`` and ``jnp.linspace``, which may differ in the last bit
of a point: 1e-6 absolute, for them and for the overlap-add they scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.ops import fold as jax_fold
from wavernn_tpu.ops import mol as jax_mol
from wavernn_tpu.ops import rnn as jax_rnn
from wavernn_tpu_torch.ops import fold, mol
from wavernn_tpu_torch.ops.rnn import gru_cell_step
from tests.torch_cpu import one_torch_thread  # noqa: F401


def test_gru_cell_step_matches_jax():
    rng = np.random.default_rng(0)
    B, I, H = 3, 24, 16
    args = [rng.standard_normal(s).astype(np.float32) * 0.5 for s in
            ((B, I), (B, H), (I, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
    want = np.asarray(jax_rnn.gru_cell_step(*map(jnp.asarray, args)))
    got = gru_cell_step(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_mol_sample_matches_jax_with_its_uniforms():
    """The JAX sampler draws its uniforms from a key; the port takes them as
    arguments, so the test draws JAX's own and hands them over."""
    rng = np.random.default_rng(1)
    nm, B = 10, 64
    y = rng.standard_normal((B, 3 * nm)).astype(np.float32)
    y[:, 2 * nm:] = rng.uniform(-40.0, 0.5, (B, nm))  # some below the floor
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_mol.sample_from_discretized_mix_logistic(
        key, jnp.asarray(y)))
    k_mix, k_log = jax.random.split(key)
    lo, hi = mol.U_MIN, mol.U_MAX
    u_mix = np.array(jax.random.uniform(k_mix, (B, nm), minval=lo, maxval=hi))
    u_log = np.array(jax.random.uniform(k_log, (B,), minval=lo, maxval=hi))
    got = mol.sample_from_discretized_mix_logistic(
        torch.from_numpy(y), torch.from_numpy(u_mix),
        torch.from_numpy(u_log)).numpy()
    assert got.shape == (B,) and np.all(np.abs(got) <= 1.0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("total,target,overlap", [
    (10, 2, 1), (1000, 200, 28), (1228, 200, 28), (5, 11000, 550),
    (527725 + 4 * 275, 11000, 550),
])
def test_fold_shape_matches_jax(total, target, overlap):
    assert fold.fold_shape(total, target, overlap) == \
        jax_fold.fold_shape(total, target, overlap)


@pytest.mark.parametrize("T,target,overlap", [(10, 2, 1), (700, 200, 28),
                                              (1229, 200, 28)])
def test_fold_and_unfold_match_jax(T, target, overlap):
    rng = np.random.default_rng(T)
    x = rng.standard_normal((1, T, 3)).astype(np.float32)
    want = np.asarray(jax_fold.fold_with_overlap(jnp.asarray(x), target,
                                                 overlap))
    got = fold.fold_with_overlap(torch.from_numpy(x), target, overlap).numpy()
    np.testing.assert_array_equal(got, want)

    y = rng.standard_normal(want.shape[:2]).astype(np.float32)
    want = np.asarray(jax_fold.xfade_and_unfold(jnp.asarray(y), overlap))
    got = fold.xfade_and_unfold(torch.from_numpy(y), overlap).numpy()
    assert got.shape == want.shape == (
        y.shape[0] * (target + overlap) + overlap,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for g, w in zip(fold.xfade_envelopes(overlap),
                    jax_fold.xfade_envelopes(overlap)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
