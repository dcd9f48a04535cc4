"""int8_ff's policy on the H100, pinned: the reference's default ("auto",
``int8_ff=None``) streams int8 feed-forward matrices from kernel width 64
on (a TPU crossover, ``wavernn_tpu/ops/decode.py:1370-1384``); the port
resolves it to bf16 feed-forward matrices at every width until the H100's
crossover is measured, and ``int8_ff=True`` raises."""

from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops.decode import Generator, int8_ff_policy
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

TINY_RAW = Path(__file__).parent / "golden" / "tiny_wavernn_raw.msgpack"
CFG = WaveRNNConfig(rnn_dims=32, fc_dims=32, compute_dims=16,
                    res_out_dims=16, res_blocks=2, mode="RAW")


def tiny_raw():
    blob = load_pytree(TINY_RAW)
    return {"params": blob["params"], "batch_stats": blob["batch_stats"]}


@pytest.mark.parametrize("n_folds", [1, 16, 63, 64, 65, 128])
def test_auto_resolves_to_bf16_at_every_width(n_folds):
    assert int8_ff_policy(None, n_folds) is False
    assert int8_ff_policy(False, n_folds) is False
    with pytest.raises(NotImplementedError, match="int8_ff"):
        int8_ff_policy(True, n_folds)


def test_width_64_or_more_dispatch_streams_bf16_feed_forward_matrices():
    gen = Generator(CFG, tiny_raw(), device="cpu", fold_bucket=16)
    mel = np.random.default_rng(0).uniform(0, 1, (80, 50)).astype(np.float32)
    staged = gen.prestage(mel, batched=True, target=200, overlap=28)
    cond, _ = gen.fold_conditioning(staged)
    assert cond.shape[0] >= 64            # the reference's auto: int8
    for name in ("w_ih2x", "w_fc1x", "w_fc2x"):
        assert gen.packed[name].dtype == torch.bfloat16, name
    with pytest.raises(NotImplementedError, match="int8_ff"):
        Generator(CFG, tiny_raw(), device="cpu", int8_ff=True)
