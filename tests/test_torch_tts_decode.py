"""The Tacotron decoder-step loop of the port (``ops/tts_decode.py``)
against the JAX package's Pallas kernel and its flax rollout, on the CPU.

Full-width seeded weights (``TacotronConfig()``, flax init).  The Pallas
kernel runs as ``tests/test_pallas_tts.py`` runs it, in interpret mode with
float32 packing.  Tolerances are JAX's own for its kernel against the flax
rollout (``tests/test_pallas_tts.py``): 2e-4 on mels, 2e-5 on scores at
float32; at bf16 a mean mel difference under 0.05 and a score difference
under 0.1 against the float32 rollout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.models.tacotron import Tacotron as JaxTacotron
from wavernn_tpu.models.tacotron import TacotronConfig as JaxConfig
from wavernn_tpu.models.tacotron import init_decoder_carry as jax_carry
from wavernn_tpu.ops import pallas_tts
from wavernn_tpu_torch.models.tacotron import TacotronConfig, from_jax_variables
from wavernn_tpu_torch.ops import cuda_tts
from wavernn_tpu_torch.ops.tts_decode import (
    STATE_FIELDS, extract_tts_decode_weights, init_tts_decode_state,
    location_windows, pack_tts_weights, tts_decode_reference,
)
from tests.torch_cpu import one_torch_thread  # noqa: F401

N_STEPS = 8


@pytest.fixture(scope="module")
def full():
    """Full-width flax variables and the port model made from them."""
    jcfg = JaxConfig()
    rng = np.random.default_rng(7)
    v = JaxTacotron(jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(rng.integers(1, jcfg.num_chars, (1, 40)), jnp.int32),
        jnp.asarray(rng.uniform(-4, 4, (1, 8, jcfg.n_mels)), jnp.float32),
        2, True)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    return jcfg, v, from_jax_variables(v, TacotronConfig(), "cpu")


def encoded(full, L, seed):
    jcfg, v, _ = full
    x = np.random.default_rng(seed).integers(1, jcfg.num_chars, (1, L))
    enc, encp = JaxTacotron(jcfg).apply(v, jnp.asarray(x, jnp.int32), False,
                                        method=JaxTacotron.encode)
    return np.array(enc[0]), np.array(encp[0])


def flax_rollout(full, enc, encp, r, n):
    jcfg, v, _ = full
    carry = jax_carry(jcfg, 1, enc.shape[0])
    prev = jnp.zeros((1, jcfg.n_mels))
    mels, scores = [], []
    for _ in range(n):
        carry, (m, s) = JaxTacotron(jcfg).apply(
            v, carry, enc[None], encp[None], prev, r,
            method=JaxTacotron.decode_step)
        prev = m[:, :, -1]
        mels.append(np.asarray(m[0]).T)        # (r, n_mels)
        scores.append(np.asarray(s[0]))
    return np.stack(mels), np.stack(scores)


def pallas_rollout(full, enc, encp, r, n):
    jcfg, v, _ = full
    L = enc.shape[0]
    L_pad = pallas_tts.attn_pad_len(L)
    packed = pallas_tts.pack_tts_weights(
        pallas_tts.extract_tts_decode_weights(v["params"]), r, jcfg.n_mels,
        dtype=jnp.float32)
    m, s, stop, _ = pallas_tts.tts_decode_chunk(
        packed, jnp.pad(enc, ((0, L_pad - L), (0, 0))),
        jnp.pad(encp.T, ((0, 0), (0, L_pad - L))),
        pallas_tts.init_tts_decode_state(jcfg.decoder_dims, jcfg.lstm_dims,
                                         L_pad),
        n, r, jcfg.n_mels, L, interpret=True)
    m = np.asarray(m).reshape(n, r, pallas_tts.LANE)[:, :, :jcfg.n_mels]
    return m, np.asarray(s)[:, :L], np.asarray(stop), np.asarray(s)[:, L:]


def port_rollout(full, enc, encp, r, n, dtype=torch.float32, chunks=1):
    _, _, model = full
    c = model.cfg
    packed = pack_tts_weights(extract_tts_decode_weights(model), r, c.n_mels,
                              dtype=dtype)
    state = init_tts_decode_state(c.decoder_dims, c.lstm_dims, enc.shape[0],
                                  c.n_mels)
    outs = []
    for _ in range(chunks):
        *o, state = tts_decode_reference(packed, torch.from_numpy(enc),
                                         torch.from_numpy(encp), state,
                                         n // chunks)
        outs.append(o)
    return [torch.cat(x).numpy() for x in zip(*outs)] + [state]


@pytest.mark.parametrize("r", [1, 2, 7])
def test_f32_packing_equals_jax_without_lane_padding(full, r):
    jcfg, v, model = full
    D, H, NM = jcfg.decoder_dims, jcfg.lstm_dims, jcfg.n_mels
    want = pallas_tts.pack_tts_weights(
        pallas_tts.extract_tts_decode_weights(v["params"]), r, NM,
        dtype=jnp.float32)
    want = {k: np.asarray(a) for k, a in want.items()}
    got = {k: t.numpy() for k, t in pack_tts_weights(
        extract_tts_decode_weights(model), r, NM,
        dtype=torch.float32).items()}
    taps = list(range(31)) + list(range(32, 63))
    mel = want["mel_w"].reshape(H, r, pallas_tts.LANE)[:, :, :NM]
    unpadded = dict(
        p1_w=want["p1_w"][:NM].T, p2_w=want["p2_w"].T,
        wih_c=want["wih_c"].T, wih_p=want["wih_p"][:D // 2].T,
        whh=want["whh"].T, M_loc=want["M_loc"][:, taps],
        W_q=want["W_qT"], b_q=want["b_q_col"][:, 0], v=want["v_row"],
        ri_c=want["ri_c"].T, ri_h=want["ri_h"].T,
        l1_ih=want["l1_ih"].T, l1_hh=want["l1_hh"].T,
        l2_ih=want["l2_ih"].T, l2_hh=want["l2_hh"].T,
        mel_w=mel.reshape(H, r * NM).T,
        **{k: want[k][0] for k in ("p1_b", "p2_b", "b_attn", "b_attn_hn",
                                   "ri_b", "l1_b", "l2_b")})
    assert set(got) == set(unpadded)
    for k in got:
        assert got[k].shape == unpadded[k].shape, k
        np.testing.assert_allclose(got[k], unpadded[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("r,L", [(1, 40), (2, 40), (7, 40), (2, 120)],
                         ids=["r1", "r2", "r7", "r2-L120"])
def test_reference_matches_pallas_and_flax(full, r, L):
    enc, encp = encoded(full, L, seed=r + L)
    mels_f, scores_f = flax_rollout(full, enc, encp, r, N_STEPS)
    mels_k, scores_k, stop_k, pad_k = pallas_rollout(full, enc, encp, r,
                                                     N_STEPS)
    mels, scores, stop, _ = port_rollout(full, enc, encp, r, N_STEPS)
    assert mels.shape == (N_STEPS, r, 80) and scores.shape == (N_STEPS, L)
    for want_m, want_s in ((mels_k, scores_k), (mels_f, scores_f)):
        np.testing.assert_allclose(mels, want_m, atol=2e-4)
        np.testing.assert_allclose(scores, want_s, atol=2e-5)
    np.testing.assert_allclose(stop, stop_k, atol=2e-4)
    np.testing.assert_array_equal(stop, mels.reshape(N_STEPS, -1).max(axis=1))
    np.testing.assert_array_equal(pad_k, 0.0)


def test_two_chunks_equal_one(full):
    enc, encp = encoded(full, 40, seed=3)
    one = port_rollout(full, enc, encp, 2, 16)
    two = port_rollout(full, enc, encp, 2, 16, chunks=2)
    for a, b in zip(one[:3], two[:3]):
        np.testing.assert_array_equal(a, b)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(one[3], f).numpy(),
                                      getattr(two[3], f).numpy())


def test_bf16_within_jax_bounds(full):
    enc, encp = encoded(full, 40, seed=5)
    mels_f, scores_f = flax_rollout(full, enc, encp, 2, N_STEPS)
    mels, scores, _, _ = port_rollout(full, enc, encp, 2, N_STEPS,
                                      dtype=torch.bfloat16)
    assert np.isfinite(mels).all()
    assert np.abs(mels - mels_f).mean() < 0.05
    assert np.abs(scores - scores_f).max() < 0.1


def test_location_windows_are_the_zero_padded_conv_taps():
    cum = torch.arange(1.0, 6.0)
    prv = -cum
    win = location_windows(cum, prv)
    assert win.shape == (5, 62)
    # row l, tap t reads position l + t - 15, zero outside [0, 5)
    for l in range(5):
        for t in range(31):
            src = l + t - 15
            want = float(cum[src]) if 0 <= src < 5 else 0.0
            assert float(win[l, t]) == want
            assert float(win[l, 31 + t]) == -want


def test_packing_and_wrapper_refuse_what_they_do_not_take(full):
    _, _, model = full
    w = extract_tts_decode_weights(model)
    with pytest.raises(ValueError, match="dtype"):
        pack_tts_weights(w, 2, 80, dtype=torch.float16, int8_lstm=True)
    with pytest.raises(ValueError, match="dtype"):
        pack_tts_weights(w, 2, 80, dtype=torch.float16)
    with pytest.raises(ValueError, match="r=21"):
        pack_tts_weights(w, 21, 80)
    packed = pack_tts_weights(w, 2, 80)
    c = model.cfg
    enc = torch.zeros(8, c.decoder_dims)
    state = init_tts_decode_state(c.decoder_dims, c.lstm_dims, 8, c.n_mels)
    with pytest.raises(ValueError, match="int8_lstm"):   # a bf16 pack
        cuda_tts.tts_decode(packed, enc, enc, state, 4, int8_lstm=True)
    with pytest.raises(ValueError, match="int8_lstm"):   # an int8 one
        cuda_tts.tts_decode(pack_tts_weights(w, 2, 80, int8_lstm=True), enc,
                            enc, state, 4)
    with pytest.raises(ValueError, match="state.cum"):
        cuda_tts.tts_decode(packed, enc, enc, init_tts_decode_state(
            c.decoder_dims, c.lstm_dims, 9, c.n_mels), 4)
    n = cuda_tts.tts_decode.launches
    got = cuda_tts.tts_decode(packed, enc, enc, state, 4)
    want = tts_decode_reference(packed, enc, enc, state, 4)
    assert cuda_tts.tts_decode.launches == n      # the CPU runs no kernel
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
