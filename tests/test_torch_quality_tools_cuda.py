"""The quality tools on the card: ``kernel_quality``'s :func:`measure`
through the decode kernel against the same measure through the kernel's
plain version, and ``tts_kernel_parity``'s kernel decode against the plain
decoder.  Every test carries the ``cuda`` marker and skips without a card;
the module imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest tests/test_torch_quality_tools_cuda.py -m cuda -q

Tolerances: each variant's deterministic mean |sample diff| to the scan
equal (the kernel is bit-equal to its plain version); the Tacotron
kernel's frames equal the plain decoder's, its mel within 1e-2 mean |d|
(bf16 weights against float32).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.tools import (
    hparams, kernel_quality, load_variables, tts_kernel_parity,
)

pytestmark = pytest.mark.cuda

REPO = Path(__file__).parent.parent
GOLDEN = REPO / "bench_assets" / "wavernn_mol_golden.msgpack"


@pytest.fixture()
def cuda_device():
    """The first CUDA device; skips where there is none (decided at test
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    set_float32_policy()
    return torch.device("cuda", 0)


def test_measure_reproduces_the_plain_versions(cuda_device, monkeypatch):
    """100 frames of the golden eval mel at target 1,100 / overlap 55 (25
    fold rows x 1,210 steps, so that the plain version runs in seconds)."""
    cfg = WaveRNNConfig()
    golden = load_variables(GOLDEN)
    mel = np.load(REPO / "bench_assets" / "golden_eval_mel.npy")[:, :100]
    args = (cfg, golden, mel, cuda_device, 0, 1100, 55, False)
    with hparams():
        n = cuda_decode.decode.launches
        kernel = kernel_quality.measure(*args)
        assert cuda_decode.decode.launches - n == 3

        def plain(packed, cond, T, seed, mode, n_classes, deterministic,
                  ablate=frozenset(), rows_per_cta=1, row0=0):
            return cuda_decode.decode_reference(
                packed, cond, T, seed, mode, n_classes, deterministic,
                ablate, row0)

        monkeypatch.setattr(cuda_decode, "decode", plain)
        want = kernel_quality.measure(*args)
    assert not hp.is_configured()
    assert set(kernel) == set(want)
    for k in kernel_quality.KERNEL_VARIANTS:
        assert kernel[f"det_absdiff_{k}"] == want[f"det_absdiff_{k}"], k
        assert 0 < kernel[f"det_absdiff_{k}"] < kernel["det_signal_std"]


def test_tts_kernel_frames_equal_plain_frames(cuda_device):
    rec = tts_kernel_parity.main(["--steps", "200", "--passes", "1"])
    assert rec["frames_plain"] == rec["frames_kernel"] == rec["frames"] == 200
    assert rec["kernel_launches"] > 0
    assert rec["mel_mean_abs_diff"] < 1e-2
    assert np.isfinite(rec["frames_per_s_kernel"])
