"""The Tacotron decoder-step kernel's shared-memory plan
(``cuda_tts.tts_smem_plan``) on the CPU.

The kernel (``ops/csrc/tts_decode.cu``) gives every CTA of its grid a
contiguous range of each phase's output units, of the text positions and of
the context columns, and keeps the weight rows of its units in shared
memory for the whole launch; its ``layout()`` computes the same bytes, and
the wrapper refuses a launch where they differ.  Here, for the full-size
model, the tiny trained golden and the card tests' small model on 1, 7, 64
and 132 CTAs: every unit is owned exactly once; the full-size model fits
on 132 CTAs (an H100's SMs) for texts of 64 and 256 symbols.  Each CTA
keeps the cumulative and previous attention of its conv window only, and
every position's 31 taps lie in its owner's window.  A text too long for
shared memory (past ``shared_text_limit``) plans the global placement: the
weights, operands, partials, conv taps and windows stay in shared memory,
the L-sized state moves to a workspace in global memory, and the ownership
is the shared plan's.  What still raises: a bad grid, a fixed part that
does not fit, a text too long for a pinned shared placement, and a text
whose conv window no longer fits beside the global placement's fixed part.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from wavernn_tpu_torch.ops.cuda_tts import (
    SMEM_LIMIT, shared_text_limit, tts_smem_plan,
)

FULL = (256, 128, 512, 80, 2)    # D, Dh, H, n_mels, r of TacotronConfig()
# the regions that grow with L, which the global placement moves out
L_SIZED = ("enc_cols", "scores", "pe_rows", "encp_rows")
# the regions of a CTA's conv window: [cum | prv] staged as doubles, then
# cum and prv as float32, each of its most positions and 15 either side
WINDOW = {"window": 16, "cum": 4, "prv": 4}
from tests.torch_cpu import one_torch_thread  # noqa: F401

META = json.loads((Path(__file__).parent / "golden"
                   / "tiny_tacotron_meta.json").read_text())
TINY = META["dims"]
# (D, Dh, H, n_mels, r, L): TacotronConfig(), the tiny golden on its eval
# text's padded length, the card tests' SMALL_TACO on a 200-symbol text
CONFIGS = {
    "full": (256, 128, 512, 80, 2, 64),
    "tiny_golden": (TINY["decoder_dims"], TINY["decoder_dims"] // 2,
                    TINY["lstm_dims"], TINY["n_mels"], META["r"], 32),
    "small_taco": (64, 32, 128, 80, 7, 200),
}


@pytest.mark.parametrize("grid", [1, 7, 64, 132])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_every_unit_is_owned_exactly_once(config, grid):
    D, Dh, H, n_mels, r, L = CONFIGS[config]
    plan = tts_smem_plan(D, Dh, H, n_mels, r, L, grid, limit=None)
    want = dict(prenet1=D, prenet2=Dh, attn_gru=D, query=D, energies=L,
                context=D, rnn_input=H, lstm1=H, lstm2=H, mel=r * n_mels)
    assert plan["units"] == want
    for phase, n in want.items():
        ranges = plan["ranges"][phase]
        assert len(ranges) == grid
        owners = [0] * n
        for start, stop in ranges:
            assert 0 <= start <= stop <= n
            assert stop - start <= plan["most"][phase]
            for u in range(start, stop):
                owners[u] += 1
        assert owners == [1] * n, phase
    assert len(plan["weight_bytes"]) == grid
    weights = sum(b for k, b in plan["regions"].items() if k.startswith("w_"))
    assert max(plan["weight_bytes"]) <= weights < plan["bytes"]


@pytest.mark.parametrize("L", [64, 256])
def test_full_width_fits_one_cta_per_h100_sm(L):
    plan = tts_smem_plan(256, 128, 512, 80, 2, L, 132)
    assert plan["bytes"] <= SMEM_LIMIT == 232_448
    assert plan["bytes"] == sum(-(-b // 16) * 16
                                for b in plan["regions"].values())
    # the largest CTA's weights: 2 x 4 LSTM units of 8 KB, 2 GRU units,
    # 4 rnn_input, 2 mel, 2 query, 2 prenet1 rows and 1 prenet2 row
    assert max(plan["weight_bytes"]) == 81_216
    assert plan["regions"]["loc_conv"] == 31 * 256 * 4


def test_layout_bytes_are_pinned():
    """The bytes the kernel's layout() gives at full width, L = 64, 132
    CTAs (the wrapper compares the two on every launch)."""
    plan = tts_smem_plan(256, 128, 512, 80, 2, 64, 132)
    assert plan["bytes"] == 129_760
    for k, b in WINDOW.items():                  # 1 position + 2 x 15
        assert plan["regions"][k] == b * 31, k


@pytest.mark.parametrize("int8_lstm", [False, True], ids=["bf16", "int8_lstm"])
@pytest.mark.parametrize("grid", [64, 132])
def test_shared_text_limit_is_the_plans_edge(grid, int8_lstm):
    """At full width: the longest text the shared placement holds is
    pinned, its plan is the shared one and fits; one symbol more plans
    the global placement, and pinned to the shared one raises."""
    limit = shared_text_limit(*FULL, grid, int8_lstm)
    assert limit == {(64, False): 372, (64, True): 1_305,
                     (132, False): 2_918, (132, True): 3_828}[
        grid, int8_lstm]
    plan = tts_smem_plan(*FULL, limit, grid, int8_lstm=int8_lstm)
    assert plan["placement"] == "shared" and plan["bytes"] <= SMEM_LIMIT
    plan = tts_smem_plan(*FULL, limit + 1, grid, int8_lstm=int8_lstm)
    assert plan["placement"] == "global" and plan["bytes"] <= SMEM_LIMIT
    with pytest.raises(ValueError, match=f"L={limit + 1}"):
        tts_smem_plan(*FULL, limit + 1, grid, int8_lstm=int8_lstm,
                      placement="shared")


def sampled_lengths():
    """Text lengths from 1 to 16,384: the edges around the grids' sizes and
    the limits, and a seeded draw."""
    edges = [1, 2, 7, 15, 16, 30, 31, 36, 37, 38, 64, 131, 132, 133, 264,
             1_000, 2_918, 2_919, 3_829, 4_096, 16_383, 16_384]
    drawn = np.random.default_rng(24).integers(1, 16_385, 12).tolist()
    return sorted(set(edges + drawn))


@pytest.mark.parametrize("grid", [1, 7, 37, 132])
def test_every_position_s_taps_lie_in_its_owner_s_window(grid):
    """Every text position's 31 taps (l - 15 .. l + 15, clipped to [0,
    L)) lie in the conv window its owner allocates: the window starts 15
    positions before the CTA's first and holds as many positions as the
    ``cum`` region (the ``prv`` and staged ``window`` regions the same),
    for L from 1 to 16,384."""
    for L in sampled_lengths():
        plan = tts_smem_plan(*FULL, L, grid, limit=None, placement="global")
        nw = plan["regions"]["cum"] // WINDOW["cum"]
        for k, b in WINDOW.items():
            assert plan["regions"][k] == b * nw, (L, k)
        for l0, l1 in plan["ranges"]["energies"]:
            w0, w1 = l0 - 15, l0 - 15 + nw
            pos = np.arange(l0, l1)
            lo = np.maximum(pos - 15, 0)
            hi = np.minimum(pos + 15, L - 1)
            assert (w0 <= lo).all() and (hi < w1).all(), (L, l0, l1)


@pytest.mark.parametrize("grid", [64, 132])
def test_a_text_too_long_to_fit_raises(grid):
    """A text of 4,000 symbols no longer raises: it plans the global
    placement, within the shared limit.  Pinned to the shared placement it
    still raises naming L; a bad grid and a fixed part that does not fit
    (full width on 8 CTAs: ~1.3 MB of weights a CTA) raise too."""
    plan = tts_smem_plan(*FULL, 4000, grid)
    assert plan["placement"] == "global"
    assert plan["bytes"] <= SMEM_LIMIT and plan["workspace"] > 0
    with pytest.raises(ValueError, match="L=4000"):
        tts_smem_plan(*FULL, 4000, grid, placement="shared")
    with pytest.raises(ValueError, match="grid"):
        tts_smem_plan(*FULL, 64, 0)
    with pytest.raises(ValueError, match="grid=8"):
        tts_smem_plan(*FULL, 4000, 8)


@pytest.mark.parametrize("int8_lstm", [False, True], ids=["bf16", "int8_lstm"])
@pytest.mark.parametrize("L", ["limit+1", 4_096, 16_384])
def test_a_long_text_plans_the_global_placement(L, int8_lstm):
    """At full width on 132 CTAs: the shared bytes are the fixed part's and
    the conv window's (which grows with the positions a CTA owns), the
    workspace is each CTA's scores (16-byte aligned) and pe (L, D), and
    the ownership and weight bytes are those of the shared plan."""
    if L == "limit+1":
        L = shared_text_limit(*FULL, 132) + 1
    plan = tts_smem_plan(*FULL, L, 132, int8_lstm=int8_lstm)
    shared = tts_smem_plan(*FULL, L, 132, limit=None, int8_lstm=int8_lstm)
    if L > shared_text_limit(*FULL, 132, int8_lstm):
        assert plan["placement"] == "global" and shared["bytes"] > SMEM_LIMIT
    assert shared["placement"] == "shared" and shared["workspace"] == 0
    glob = tts_smem_plan(*FULL, L, 132, int8_lstm=int8_lstm,
                         placement="global")
    assert glob["bytes"] <= SMEM_LIMIT
    assert glob["bytes"] == {2_919: (126_976, 94_656),
                             4_096: (127_184, 94_864),
                             16_384: (129_408, 97_088)}[L][int8_lstm]
    assert glob["bytes"] == sum(-(-b // 16) * 16
                                for b in glob["regions"].values())
    assert all(glob["regions"][k] == 0 for k in L_SIZED)
    for k, b in WINDOW.items():
        assert glob["regions"][k] == b * (-(-L // 132) + 30), k
    stride = -(-L // 4) * 4                      # floats, 16-byte aligned
    assert glob["workspace"] == 132 * stride * 4 + L * 256 * 4
    for key in ("units", "most", "ranges", "weight_bytes"):
        assert glob[key] == shared[key], key


@pytest.mark.parametrize("int8_lstm", [False, True], ids=["bf16", "int8_lstm"])
@pytest.mark.parametrize("grid", [64, 132])
def test_a_text_past_the_global_window_s_edge_raises(grid, int8_lstm):
    """The global placement keeps each CTA's conv window in shared memory
    (24 bytes a position it owns), so at full width it holds texts up to
    a pinned edge: the longest text plans the global placement and fits,
    one symbol more raises naming L and its window, not the grid."""
    edge = {(64, False): 68_800, (64, True): 241_344,
            (132, False): 583_176, (132, True): 760_980}[grid, int8_lstm]
    plan = tts_smem_plan(*FULL, edge, grid, int8_lstm=int8_lstm)
    assert plan["placement"] == "global" and plan["bytes"] <= SMEM_LIMIT
    nw = -(-(edge + 1) // grid) + 30
    with pytest.raises(ValueError,
                       match=f"L={edge + 1} .*global placement.*window of "
                             f"{nw} positions"):
        tts_smem_plan(*FULL, edge + 1, grid, int8_lstm=int8_lstm)


@pytest.mark.parametrize("L", [64, 256, "limit"])
def test_a_text_that_fits_keeps_the_shared_plan(L):
    """Up to the shared limit (2,918 symbols at full width on 132 CTAs) the
    plan is the shared placement's, byte for byte, with no workspace."""
    if L == "limit":
        L = shared_text_limit(*FULL, 132)
    plan = tts_smem_plan(*FULL, L, 132)
    assert plan["placement"] == "shared" and plan["workspace"] == 0
    assert plan == tts_smem_plan(*FULL, L, 132, placement="shared")
    assert plan["bytes"] <= SMEM_LIMIT
    assert plan["bytes"] == {64: 129_760, 256: 135_664, 2_918: 232_448}[L]
    assert all(plan["regions"][k] > 0 for k in L_SIZED)
