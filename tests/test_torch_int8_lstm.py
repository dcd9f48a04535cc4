"""int8_lstm, the Tacotron decoder kernel's variant with the four LSTM
matrices int8 and their operands quantized on the fly, against the JAX
package: the packing, the kernel's plain version
(``ops/tts_decode.py::tts_decode_reference``) against the Pallas kernel in
interpret mode, ``TTSGenerator(int8_lstm=True)`` against JAX's Pallas
generator, and the kernel's shared-memory plan with int8 LSTM rows.  The
CUDA kernel is held to its plain version in ``tests/test_torch_cuda.py``.

Tolerances: the packs bit for bit (both quantize in float32 in the same
order).  The plain version against the Pallas kernel, 8 steps at full
width (r = 2, L = 40): with float32 packing JAX's own tolerance for its
float32 kernel against the flax rollout (``tests/test_pallas_tts.py``),
2e-4 on mels and 2e-5 on scores; with bf16 packing 2e-3 on mels and 1e-4
on scores (the int8 sums are exact in both; the bf16 dots are summed in
float32 by JAX and in float64 by the port, and a last-bit difference that
rounds a bf16 operand to its neighbour moves a product by 2**-8 of
itself).  The generator on the trained tiny golden: the same frame count,
the mean mel difference under 0.05 and the attention within 0.1, the
tolerance JAX gives its int8_lstm kernel against the float32 rollout (a
trained autoregressive decode carries such differences forward).  Models
are the port's seeded ``init_variables`` in JAX layout, so no JAX init
compiles."""

import functools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.infer.tacotron import TTSGenerator as JaxTTSGenerator
from wavernn_tpu.models.tacotron import TacotronConfig as JaxConfig
from wavernn_tpu.ops import pallas_tts
from wavernn_tpu_torch.infer.tacotron import TTSGenerator
from wavernn_tpu_torch.models.tacotron import (
    TacotronConfig, from_jax_variables, init_variables,
)
from wavernn_tpu_torch.ops.cuda_tts import (
    SMEM_LIMIT, shared_text_limit, tts_smem_plan,
)
from wavernn_tpu_torch.ops.tts_decode import (
    LSTM_MATRICES, extract_tts_decode_weights, init_tts_decode_state,
    is_int8_lstm, pack_tts_weights, tts_decode_reference,
)
from wavernn_tpu_torch.text import text_to_sequence
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
META = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def full():
    """Full-width seeded variables (JAX layout), the port model made from
    them and its encoder outputs on a 40-symbol text."""
    cfg = TacotronConfig()
    v = init_variables(cfg, 0)
    model = from_jax_variables(v, cfg, "cpu")
    x = np.random.default_rng(3).integers(1, cfg.num_chars, (1, 40))
    with torch.no_grad():
        enc, encp = model.encode(torch.from_numpy(x))
    return cfg, v, model, enc[0].numpy(), encp[0].numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pack_tts_weights_int8_lstm_bit_equal(full, dtype):
    """The four int8 LSTM matrices (stored (out, in)) and their scales
    equal the Pallas pack's; every other matrix is the ``dtype`` pack's."""
    cfg, v, model, _, _ = full
    tdt, jdt = DTYPES[dtype]
    pj = pallas_tts.pack_tts_weights(
        pallas_tts.extract_tts_decode_weights(v["params"]), 2, cfg.n_mels,
        dtype=jdt, int8_lstm=True)
    w = extract_tts_decode_weights(model)
    pt = pack_tts_weights(w, 2, cfg.n_mels, dtype=tdt, int8_lstm=True)
    assert is_int8_lstm(pt)
    for name in LSTM_MATRICES:
        q, s = pt[name], pt[name + "_s"]
        assert q.dtype == torch.int8 and q.shape == (4 * cfg.lstm_dims,
                                                     cfg.lstm_dims), name
        np.testing.assert_array_equal(q.numpy(), np.asarray(pj[name]).T)
        np.testing.assert_array_equal(s.numpy(),
                                      np.asarray(pj[name + "_s"])[0])
    plain = pack_tts_weights(w, 2, cfg.n_mels, dtype=tdt)
    assert not is_int8_lstm(plain)
    assert set(pt) == set(plain) | {k + "_s" for k in LSTM_MATRICES}
    for name in set(plain) - set(LSTM_MATRICES):
        assert torch.equal(pt[name], plain[name]), name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reference_int8_lstm_matches_pallas_interpret(full, dtype):
    cfg, v, model, enc, encp = full
    tdt, jdt = DTYPES[dtype]
    r, n, L = 2, 8, enc.shape[0]
    L_pad = pallas_tts.attn_pad_len(L)
    pj = pallas_tts.pack_tts_weights(
        pallas_tts.extract_tts_decode_weights(v["params"]), r, cfg.n_mels,
        dtype=jdt, int8_lstm=True)
    m, s, stop, _ = pallas_tts.tts_decode_chunk(
        pj, jnp.pad(enc, ((0, L_pad - L), (0, 0))),
        jnp.pad(encp.T, ((0, 0), (0, L_pad - L))),
        pallas_tts.init_tts_decode_state(cfg.decoder_dims, cfg.lstm_dims,
                                         L_pad),
        n, r, cfg.n_mels, L, interpret=True, int8_lstm=True)
    m = np.asarray(m).reshape(n, r, pallas_tts.LANE)[:, :, :cfg.n_mels]
    s = np.asarray(s)[:, :L]
    pt = pack_tts_weights(extract_tts_decode_weights(model), r, cfg.n_mels,
                          dtype=tdt, int8_lstm=True)
    state = init_tts_decode_state(cfg.decoder_dims, cfg.lstm_dims, L,
                                  cfg.n_mels)
    mels, scores, stp, _ = tts_decode_reference(
        pt, torch.from_numpy(enc), torch.from_numpy(encp), state, n)
    atol_m, atol_s = (2e-4, 2e-5) if dtype == "float32" else (2e-3, 1e-4)
    np.testing.assert_allclose(mels.numpy(), m, atol=atol_m)
    np.testing.assert_allclose(scores.numpy(), s, atol=atol_s)
    np.testing.assert_allclose(stp.numpy(), np.asarray(stop), atol=atol_m)
    # the variant differs from the plain packing's decode
    bf = tts_decode_reference(pack_tts_weights(
        extract_tts_decode_weights(model), r, cfg.n_mels, dtype=tdt),
        torch.from_numpy(enc), torch.from_numpy(encp), state, n)
    assert not torch.equal(bf[0], mels)


@pytest.fixture()
def golden():
    blob = load_pytree(GOLDEN / "tiny_tacotron.msgpack")
    v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    return v, text_to_sequence(META["eval_text"], ["english_cleaners"])


def test_tts_generator_int8_lstm_matches_jax_pallas(golden, monkeypatch):
    """The trained tiny golden through ``TTSGenerator(int8_lstm=True)``:
    the port's kernel backend (its plain version on the CPU) against JAX's
    Pallas backend in interpret mode."""
    v, seq = golden
    monkeypatch.setattr(pallas_tts, "tts_decode_chunk", functools.partial(
        pallas_tts.tts_decode_chunk, interpret=True))
    want = JaxTTSGenerator(JaxConfig(**META["dims"]), v, steps=400,
                           backend="pallas", int8_lstm=True)(seq, r=2)
    gen = TTSGenerator(TacotronConfig(**META["dims"]), v, "cpu", steps=400,
                       backend="kernel", int8_lstm=True)
    got = gen(seq, r=2)
    assert gen.int8_lstm and is_int8_lstm(gen._packed_for(2))
    for a, b in zip(got, want):
        assert a.shape == b.shape
    assert np.abs(got[0] - want[0]).mean() < 0.05
    assert np.abs(got[2] - want[2]).max() < 0.1


def test_plain_backend_ignores_int8_lstm(golden):
    """As the JAX package's XLA backend does."""
    v, seq = golden
    cfg = TacotronConfig(**META["dims"])
    a = TTSGenerator(cfg, v, "cpu", steps=400, int8_lstm=True)(seq, r=2)
    b = TTSGenerator(cfg, v, "cpu", steps=400)(seq, r=2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- the shared-memory plan -----------------------------------------------

FULL = (256, 128, 512, 80, 2)    # D, Dh, H, n_mels, r of TacotronConfig()


def text_limit(grid: int, int8_lstm: bool) -> int:
    """The longest text whose shared placement fits on ``grid`` CTAs."""
    lo, hi = 1, 20_000
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            tts_smem_plan(*FULL, mid, grid, int8_lstm=int8_lstm,
                          placement="shared")
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


def test_int8_lstm_plan_bytes_are_pinned():
    """At full width, L = 64, 132 CTAs: the LSTM rows take one byte a
    weight and 32 bytes of scales a unit, and ``lstm_hh`` 192 bytes: the 8
    warps' two maxima and the h half of both LSTMs' gates (4 units x 2
    layers x 4 gates, float32; the kernel's layout() computes the same
    bytes); the ownership is the bf16 plan's."""
    plan = tts_smem_plan(*FULL, 64, 132, int8_lstm=True)
    bf16 = tts_smem_plan(*FULL, 64, 132)
    assert plan["bytes"] == 97_440 and bf16["bytes"] == 129_760
    assert plan["regions"]["w_lstm1"] == 4 * (8 * 512 + 32)
    assert plan["regions"]["lstm_hh"] == 192 and "lstm_hh" not in bf16[
        "regions"]
    assert max(plan["weight_bytes"]) == 48_704
    assert plan["ranges"] == bf16["ranges"]
    assert plan["bytes"] == sum(-(-b // 16) * 16
                                for b in plan["regions"].values())


def test_int8_lstm_moves_the_text_limit():
    """At full width on 132 CTAs (an H100's SMs) the shared placement
    holds 2,918 symbols with bf16 LSTM rows, 3,828 with int8 ones
    (``shared_text_limit``, and a bisection of the plan); pinned to it, a
    text past the limit still raises, and unpinned it plans the global
    placement."""
    assert shared_text_limit(*FULL, 132) == text_limit(132, False) == 2_918
    limit = shared_text_limit(*FULL, 132, True)
    assert limit == text_limit(132, True) == 3_828
    plan = tts_smem_plan(*FULL, limit, 132, int8_lstm=True)
    assert plan["bytes"] <= SMEM_LIMIT and plan["placement"] == "shared"
    with pytest.raises(ValueError, match=f"L={limit + 1}"):
        tts_smem_plan(*FULL, limit + 1, 132, int8_lstm=True,
                      placement="shared")
    plan = tts_smem_plan(*FULL, limit + 1, 132, int8_lstm=True)
    assert plan["bytes"] <= SMEM_LIMIT and plan["placement"] == "global"


@pytest.mark.parametrize("placement", ["shared", "global"])
@pytest.mark.parametrize("grid", [1, 7, 64, 132])
def test_int8_lstm_plan_is_the_layout_written_out(grid, placement):
    """At full width, L = 64, the plan's bytes against the kernel's layout
    written out region by region (each rounded up to 16 bytes, sized for
    the most units a CTA owns): the operand as doubles and as float32 (the
    widest phase's; phase 2's p1 with h1 and h2 is narrower here), the
    conv window (its most positions and 15 either side: [cum | prv] as
    doubles, then cum and prv as float32), the L-sized state (none in the
    global placement), the partials, the conv taps, the owned state, the
    8 warps' two maxima and the h half of both LSTMs' gates (2 layers x 4
    gates a unit, float32), and the weight rows, the LSTM ones int8 with 8
    float32 scales a unit."""
    D, Dh, H, NM, r = FULL
    L = 64
    a = lambda n: -(-n // 16) * 16
    most = lambda n: -(-n // grid)
    Ls, nl = (L, most(L)) if placement == "shared" else (0, 0)
    op_n = max(NM, 2 * D + Dh, 2 * H, D + H)
    nd, nh, nw = most(D), most(H), most(L) + 30
    fixed = (a(8 * op_n) + a(8 * 8 * 6) + a(8 * 2 * nw) + a(4 * op_n)
             + 2 * a(4 * nw) + a(4 * (nd + 2 * nh)) + a(4 * 31 * D))
    text = a(8 * nd * Ls) + a(4 * Ls) + 2 * a(4 * nl * D)
    hoisted = a(4 * (2 * 8 + 2 * 4 * nh))
    weights = (a(2 * nd * NM) + a(2 * most(Dh) * D)
               + a(2 * nd * (3 * (D + Dh) + 3 * D)) + a(2 * nd * D)
               + a(2 * nh * 2 * D) + 2 * a(nh * (8 * H + 8 * 4))
               + a(2 * most(r * NM) * H))
    plan = tts_smem_plan(*FULL, L, grid, limit=None, int8_lstm=True,
                         placement=placement)
    assert plan["placement"] == placement
    assert plan["regions"]["lstm_hh"] == 64 + 32 * nh
    assert plan["bytes"] == fixed + text + hoisted + weights
    bf16 = tts_smem_plan(*FULL, L, grid, limit=None, placement=placement)
    assert bf16["bytes"] - plan["bytes"] == (
        2 * a(2 * nh * 8 * H) - 2 * a(nh * (8 * H + 32)) - hoisted)
