"""The Tacotron decoder-step kernel's shared-memory plan
(``cuda_tts.tts_smem_plan``) on the CPU.

The kernel (``ops/csrc/tts_decode.cu``) gives every CTA of its grid a
contiguous range of each phase's output units, of the text positions and of
the context columns, and keeps the weight rows of its units in shared
memory for the whole launch; its ``layout()`` computes the same bytes, and
the wrapper refuses a launch where they differ.  Here, for the full-size
model, the tiny trained golden and the card tests' small model on 1, 7, 64
and 132 CTAs: every unit is owned exactly once; the full-size model fits
on 132 CTAs (an H100's SMs) for texts of 64 and 256 symbols.  A text too
long for shared memory plans the global placement: the weights, operands,
partials and conv taps stay in shared memory, the L-sized state moves to a
workspace in global memory, and the ownership is the shared plan's.  What
still raises: a bad grid, a fixed part that does not fit, and a text too
long for a pinned shared placement.
"""

import json
from pathlib import Path

import pytest

from wavernn_tpu_torch.ops.cuda_tts import SMEM_LIMIT, tts_smem_plan

FULL = (256, 128, 512, 80, 2)    # D, Dh, H, n_mels, r of TacotronConfig()
# the regions that grow with L, which the global placement moves out
L_SIZED = ("enc_cols", "cum", "prv", "scores", "ploc", "encp_rows")
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
    assert tts_smem_plan(256, 128, 512, 80, 2, 64, 132)["bytes"] == 130_032


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
@pytest.mark.parametrize("L", [2_405, 4_096, 16_384])
def test_a_long_text_plans_the_global_placement(L, int8_lstm):
    """At full width on 132 CTAs: the shared bytes are the fixed part's
    alone (the same for every L), the workspace is each CTA's cum, prv and
    scores (16-byte aligned) and ploc (L, D), and the ownership and weight
    bytes are those of the shared plan."""
    plan = tts_smem_plan(*FULL, L, 132, int8_lstm=int8_lstm)
    shared = tts_smem_plan(*FULL, L, 132, limit=None, int8_lstm=int8_lstm)
    if L > 3_168 or not int8_lstm:
        assert plan["placement"] == "global" and shared["bytes"] > SMEM_LIMIT
    assert shared["placement"] == "shared" and shared["workspace"] == 0
    glob = tts_smem_plan(*FULL, L, 132, int8_lstm=int8_lstm,
                         placement="global")
    assert glob["bytes"] <= SMEM_LIMIT
    assert glob["bytes"] == (93_872 if int8_lstm else 126_192)
    assert glob["bytes"] == sum(-(-b // 16) * 16
                                for b in glob["regions"].values())
    assert all(glob["regions"][k] == 0 for k in L_SIZED)
    stride = -(-L // 4) * 4                      # floats, 16-byte aligned
    assert glob["workspace"] == 132 * 3 * stride * 4 + L * 256 * 4
    for key in ("units", "most", "ranges", "weight_bytes"):
        assert glob[key] == shared[key], key


@pytest.mark.parametrize("L", [64, 256, 2_404])
def test_a_text_that_fits_keeps_the_shared_plan(L):
    """Up to 2,404 symbols at full width on 132 CTAs the plan is the
    shared placement's, byte for byte, with no workspace."""
    plan = tts_smem_plan(*FULL, L, 132)
    assert plan["placement"] == "shared" and plan["workspace"] == 0
    assert plan == tts_smem_plan(*FULL, L, 132, placement="shared")
    assert plan["bytes"] <= SMEM_LIMIT
    assert plan["bytes"] == {64: 130_032, 256: 137_456, 2_404: 232_416}[L]
    assert all(plan["regions"][k] > 0 for k in L_SIZED)
