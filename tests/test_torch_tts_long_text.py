"""A text past the TTS kernel's shared-memory limit (2,918 symbols at full
width on 132 CTAs, ``cuda_tts.shared_text_limit``): the port's plain
decoder, which the kernel's global placement is held to on the card,
against the JAX package's Pallas kernel (interpret mode, float32 packing)
and its flax rollout, on the CPU.

Full-width weights drawn by the port's ``init_variables`` (flax's init
laws, seed 0; no JAX init to compile), r = 2, L = 2,919, eight steps (the
Pallas kernel's step tile).  The JAX encoder and decoder step run under
``jax.jit`` (the same flax methods as ``tests/test_torch_tts_decode.py``'s
eager rollout, ~4x faster at this length).  The tolerances are that file's
(JAX's own for its kernel against the flax rollout): 2e-4 on mels, 2e-5 on
scores.  The JAX kernel pads the text to ``attn_pad_len(L)`` and has no
length cut below its VMEM limit; the port's plan puts this text in the
global placement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_tts_decode import pallas_rollout, port_rollout
from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu.models.tacotron import Tacotron as JaxTacotron
from wavernn_tpu.models.tacotron import TacotronConfig as JaxConfig
from wavernn_tpu.models.tacotron import init_decoder_carry as jax_carry
from wavernn_tpu_torch.models.tacotron import (
    TacotronConfig, from_jax_variables, init_variables,
)
from wavernn_tpu_torch.ops.cuda_tts import shared_text_limit, tts_smem_plan

R, N_STEPS = 2, 8
L = shared_text_limit(256, 128, 512, 80, R, 132) + 1   # 2,919


@pytest.fixture(scope="module")
def full():
    v = init_variables(TacotronConfig(), 0)
    return JaxConfig(), v, from_jax_variables(v, TacotronConfig(), "cpu")


def jax_encoded(full, seed):
    jcfg, v, _ = full
    x = np.random.default_rng(seed).integers(1, jcfg.num_chars, (1, L))
    enc, encp = jax.jit(lambda v, x: JaxTacotron(jcfg).apply(
        v, x, False, method=JaxTacotron.encode))(v, jnp.asarray(x, jnp.int32))
    return np.array(enc[0]), np.array(encp[0])


def flax_rollout(full, enc, encp):
    jcfg, v, _ = full
    step = jax.jit(lambda v, carry, prev: JaxTacotron(jcfg).apply(
        v, carry, enc[None], encp[None], prev, R,
        method=JaxTacotron.decode_step))
    carry, prev = jax_carry(jcfg, 1, L), jnp.zeros((1, jcfg.n_mels))
    mels, scores = [], []
    for _ in range(N_STEPS):
        carry, (m, s) = step(v, carry, prev)
        prev = m[:, :, -1]
        mels.append(np.asarray(m[0]).T)        # (r, n_mels)
        scores.append(np.asarray(s[0]))
    return np.stack(mels), np.stack(scores)


def test_reference_past_the_shared_limit_matches_pallas_and_flax(full):
    jcfg = full[0]
    plan = tts_smem_plan(jcfg.decoder_dims, jcfg.decoder_dims // 2,
                         jcfg.lstm_dims, jcfg.n_mels, R, L, 132)
    assert plan["placement"] == "global"
    enc, encp = jax_encoded(full, seed=11)
    mels_f, scores_f = flax_rollout(full, enc, encp)
    mels_k, scores_k, stop_k, pad_k = pallas_rollout(full, enc, encp, R,
                                                     N_STEPS)
    mels, scores, stop, _ = port_rollout(full, enc, encp, R, N_STEPS)
    assert mels.shape == (N_STEPS, R, 80) and scores.shape == (N_STEPS, L)
    for want_m, want_s in ((mels_k, scores_k), (mels_f, scores_f)):
        np.testing.assert_allclose(mels, want_m, atol=2e-4)
        np.testing.assert_allclose(scores, want_s, atol=2e-5)
    np.testing.assert_allclose(stop, stop_k, atol=2e-4)
    np.testing.assert_array_equal(pad_k, 0.0)
    # the attention spreads over the whole text: every position is read
    assert (scores > 0).all() and np.isfinite(mels).all()
