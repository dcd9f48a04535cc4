"""Tacotron training on the card: the fused BiGRU (cuDNN's) against the
eager step loop, and the teacher-forced train step on the card against the
CPU.  Every test carries the ``cuda`` marker and skips without a card; the
module imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest tests/test_torch_tts_training_cuda.py -m cuda -q

Tolerances: the fused BiGRU within 1e-5 of the loop (float32, 100 steps
at the CBHG's width), its gradients within 1e-4 relative L2; the train
step in float64 on the card within 1e-9 of the CPU (loss, every gradient,
the BatchNorm statistics), and in float32 the loss within 1e-5 and the
statistics within 1e-5.
"""

import numpy as np
import pytest
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.models.tacotron import (
    TacotronConfig, draw_decoder_masks, from_jax_variables, init_variables,
    keep_mask,
)
from wavernn_tpu_torch.ops.rnn import BiGRU

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    """The first CUDA device; skips where there is none (decided at test
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    set_float32_policy()
    return torch.device("cuda", 0)


def rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def test_fused_bigru_on_card_matches_the_loop(cuda_device):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gru = BiGRU(128, 128).to(cuda_device)
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 100, 128)).astype(np.float32)).to(cuda_device)
    outs, grads = [], []
    for fused in (True, False):
        gru.zero_grad()
        y = gru(xs, fused=fused)
        (y * y).mean().backward()
        outs.append(y.detach())
        grads.append({n: p.grad.clone() for n, p in gru.named_parameters()})
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-5
    for n in grads[1]:
        assert rel_l2(grads[0][n], grads[1][n]) <= 1e-4, n


def small_cfg():
    return TacotronConfig(embed_dims=64, encoder_dims=32, decoder_dims=64,
                          postnet_dims=32, encoder_K=4, lstm_dims=96,
                          postnet_K=3, num_highways=2)


def one_step(cfg, variables, device, dtype, batch, masks, r=2):
    """Loss, per-tensor gradients and updated running statistics of one
    train-mode forward and backward."""
    model = from_jax_variables(variables, cfg, device).to(dtype).train()
    x, m = batch
    x, m = x.to(device), m.to(device, dtype)
    dec, enc = masks
    m1, m2, _ = model(x, m, r, True, masks=[t.to(device) for t in dec],
                      encoder_masks=[t.to(device) for t in enc])
    loss = (m1 - m).abs().mean() + (m2 - m).abs().mean()
    loss.backward()
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    stats = {n: b.cpu() for n, b in model.named_buffers() if "running" in n}
    return float(loss.detach()), grads, stats


def test_train_step_on_card_matches_cpu(cuda_device):
    cfg = small_cfg()
    v = init_variables(cfg, 0)
    rng = np.random.default_rng(0)
    B, L, T, r = 3, 17, 24, 2
    batch = (torch.from_numpy(rng.integers(1, cfg.num_chars, (B, L))),
             torch.from_numpy(rng.uniform(-4, 4, (B, T, cfg.n_mels))))
    g = torch.Generator().manual_seed(1)
    masks = (draw_decoder_masks(cfg, T // r, B, "cpu", g),
             [keep_mask((B, L, w), 0.5, "cpu", g)
              for w in (2 * cfg.encoder_dims, cfg.encoder_dims)])
    runs = {(d, dt): one_step(cfg, v, d, dt, batch, masks)
            for d in (cuda_device, torch.device("cpu"))
            for dt in (torch.float64, torch.float32)}
    for dt, tol in ((torch.float64, 1e-9), (torch.float32, 1e-5)):
        (lc, gc, sc), (lp, gp, sp) = (runs[(cuda_device, dt)],
                                      runs[(torch.device("cpu"), dt)])
        assert abs(lc - lp) <= tol * abs(lp), dt
        for n in sp:
            assert float((sc[n] - sp[n]).abs().max()) <= tol, (dt, n)
        if dt == torch.float64:
            for n in gp:
                if float(gp[n].abs().max()) > 0:
                    assert rel_l2(gc[n], gp[n]) <= tol, n
