"""The decode kernel's sampling law, on its plain version, against the
analytic law and against the JAX package's ``decode_scan`` (sampling mode,
on the CPU).

With all weights zero except the fc3 bias (``kernel_sampling_stats``'s
construction, H = F = 32), every draw comes from a known law: RAW, a
softmax over 512 classes with 24 in its support; MOL, a mixture of 10
logistics, read through nearest-mean cells.  The two packages draw from
different random streams, so they compare as distributions: each
total-variation distance must lie within 4x the noise floor
sqrt(K / (2 pi N)), an upper bound on the expected TV of N = 4,096 draws
to their law.  The CUDA kernel's draws are checked the same way by
``chip_smoke.py`` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.kernel_sampling_stats import const_logit_weights as jax_weights
from wavernn_tpu.ops.decode import decode_scan as jax_decode_scan
from wavernn_tpu_torch.tools import kernel_sampling_stats as ks
from tests.torch_cpu import one_torch_thread  # noqa: F401

H = F = 32
B, T = 8, 512
N = B * T


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's eager sample loop, which threads
    would only contend for beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(bias, mode, seed):
    w = jax_weights(H, F, ks.FEAT, ks.AUX_D, len(bias), bias)
    out = jax_decode_scan(
        w, jnp.zeros((B, T, ks.FEAT)), jnp.zeros((B, T, 4 * ks.AUX_D)),
        jax.random.PRNGKey(seed), mode=mode, n_classes=len(bias))
    return np.asarray(out, np.float64).ravel()


def port_draws(bias, mode, seed):
    return ks.draw(bias, mode, B, T, seed, "cpu", H, F, plain=True)


def test_raw_law():
    logits, probs = ks.raw_law()
    hp = ks.raw_hist(port_draws(logits, "RAW", 1))
    hj = ks.raw_hist(jax_draws(logits, "RAW", 2))
    floor = ks.noise_floor(ks.SUPPORT, N)
    assert ks.tv_distance(hp, probs) <= 4 * floor
    assert ks.tv_distance(hj, probs) <= 4 * floor
    assert ks.tv_distance(hp, hj) <= 4 * floor
    assert hp[probs < 1e-6].sum() == 0          # nothing off the support


def test_mol_law():
    bias, pw, mu, s = ks.mol_law()
    cells = ks.mol_cell_law(pw, mu, s)
    assert cells.sum() == pytest.approx(1.0)
    xp, xj = port_draws(bias, "MOL", 3), jax_draws(bias, "MOL", 4)
    floor = ks.noise_floor(ks.NM, N)
    cp, cj = ks.mol_cells(xp, mu), ks.mol_cells(xj, mu)
    assert ks.tv_distance(cp, cells) <= 4 * floor
    assert ks.tv_distance(cj, cells) <= 4 * floor
    assert ks.tv_distance(cp, cj) <= 4 * floor
    mean, std = ks.mol_moments(pw, mu, s)
    for x in (xp, xj):
        assert abs(x.mean() - mean) <= 4 * std / np.sqrt(N)
        assert np.all(np.abs(x) <= 1.0)


def test_sampling_stats_record_on_cpu():
    res = ks.sampling_stats(4, 256, "cpu", H=H, F=F)
    assert res["ok"] is True
    assert res["raw_tv_expected_noise"] == pytest.approx(
        np.sqrt(24 / (2 * np.pi * 1024)))
