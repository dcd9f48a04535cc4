"""The port's CUDA decode kernel on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit, carries the
``cuda`` marker and skips elsewhere.  The module imports no JAX, so that it
runs on a machine with the card, where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Weights are the port's own seeded initialization at a small width.  The
kernel and its plain version (``cuda_decode.decode_reference``) sum the
exact bf16 products of every dot in float64, so they agree to the bit
nearly always; the tolerance is the one ``chip_smoke.py`` states: first
64 steps within 1e-3, at least 99% of samples within 2e-2 (deterministic),
first 64 steps within 1e-2 (sampling).
"""

import numpy as np
import pytest
import torch

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.models.wavernn import WaveRNN, WaveRNNConfig
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.ops.decode import Generator, extract_decode_weights

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    """The first CUDA device; skips where there is none (decided at test
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    set_float32_policy()
    return torch.device("cuda", 0)


def small(mode):
    cfg = WaveRNNConfig(rnn_dims=64, fc_dims=64, compute_dims=32,
                        res_out_dims=32, res_blocks=2, mode=mode)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = WaveRNN(cfg).eval()
    return cfg, model


def variables_of(model: WaveRNN, cfg: WaveRNNConfig) -> dict:
    """The JAX-layout numpy pytree of a port model (the inverse of
    ``from_jax_variables``), for building a Generator from it."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    conv = lambda w: np.transpose(w, (2, 1, 0))
    bn = lambda pre: ({"scale": sd[f"{pre}.weight"], "bias": sd[f"{pre}.bias"]},
                      {"mean": sd[f"{pre}.running_mean"],
                       "var": sd[f"{pre}.running_var"]})
    rp, rs = {}, {}
    rp["conv_in"] = {"kernel": conv(sd["upsample.resnet.conv_in.weight"])}
    rp["bn"], rs["bn"] = bn("upsample.resnet.bn")
    for i in range(cfg.res_blocks):
        pre = f"upsample.resnet.blocks.{i}"
        bp, bs = {}, {}
        bp["conv1"] = {"kernel": conv(sd[f"{pre}.conv1.weight"])}
        bp["conv2"] = {"kernel": conv(sd[f"{pre}.conv2.weight"])}
        bp["bn1"], bs["bn1"] = bn(f"{pre}.bn1")
        bp["bn2"], bs["bn2"] = bn(f"{pre}.bn2")
        rp[f"block{i}"], rs[f"block{i}"] = bp, bs
    rp["conv_out"] = {"kernel": conv(sd["upsample.resnet.conv_out.weight"]),
                      "bias": sd["upsample.resnet.conv_out.bias"]}
    up = {f"up{i}_kernel": sd[f"upsample.up_kernels.{i}"]
          for i in range(len(cfg.upsample_factors))}
    up["resnet"] = rp
    params = {"upsample": up}
    for name in ("I", "fc1", "fc2", "fc3"):
        params[name] = {"kernel": sd[f"{name}.weight"].T,
                        "bias": sd[f"{name}.bias"]}
    for name in ("rnn1", "rnn2"):
        params[name] = {"cell": {
            "w_ih": sd[f"{name}.weight_ih"].T, "w_hh": sd[f"{name}.weight_hh"].T,
            "b_ih": sd[f"{name}.bias_ih"], "b_hh": sd[f"{name}.bias_hh"]}}
    return {"params": params, "batch_stats": {"upsample": {"resnet": rs}}}


def packed_on(model, cfg, device, int8_hh):
    packed = cuda_decode.pack_weights(extract_decode_weights(model),
                                      cfg.feat_dims, cfg.aux_dims,
                                      int8_hh=int8_hh)
    return {k: (t.to(device) if t is not None else None)
            for k, t in packed.items()}


def conditioning(cfg, B, T, device, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (B, T, cfg.feat_dims + cfg.res_out_dims))
    return torch.from_numpy(c.astype(np.float32)).to(torch.bfloat16).to(
        device)


@pytest.mark.parametrize("det", [True, False], ids=["argmax", "sampling"])
@pytest.mark.parametrize("int8_hh", [True, False], ids=["int8_hh", "bf16"])
@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_kernel_matches_plain_version(cuda_device, mode, int8_hh, det):
    cfg, model = small(mode)
    packed = packed_on(model, cfg, cuda_device, int8_hh)
    B, T = 5, 300                 # an odd row count: a half-empty CTA
    cond = conditioning(cfg, B, T, cuda_device)
    n = cuda_decode.decode.launches
    got = cuda_decode.decode(packed, cond, T, 3, mode, cfg.n_classes, det)
    torch.cuda.synchronize()
    assert cuda_decode.decode.launches == n + 1
    assert got.is_cuda and got.shape == (B, T) and got.dtype == torch.float32
    want = cuda_decode.decode_reference(packed, cond, T, 3, mode,
                                        cfg.n_classes, det)
    d = (got - want).abs().cpu().numpy()
    if det:
        assert d[:, :64].max() <= 1e-3
        assert np.mean(d <= 2e-2) >= 0.99
    else:
        assert d[:, :64].max() <= 1e-2
    assert torch.isfinite(got).all() and got.abs().max() <= 1.0


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    cfg, model = small("MOL")
    packed = packed_on(model, cfg, cuda_device, True)
    cond = conditioning(cfg, 2, 16, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_decode.decode(packed, cond.transpose(0, 1).contiguous()
                           .transpose(0, 1), 16, 0, "MOL", 30, True)
    cpu_packed = packed_on(model, cfg, "cpu", True)
    with pytest.raises(ValueError, match="packed"):
        cuda_decode.decode(cpu_packed, cond, 16, 0, "MOL", 30, True)
    with pytest.raises(ValueError, match="n_classes"):
        cuda_decode.decode(packed, cond, 16, 0, "MOL", 31, True)


def test_generator_on_card_matches_cpu(cuda_device):
    """The slice on the card goes through the kernel, once per request,
    and gives the int16 PCM the same Generator gives on the CPU."""
    cfg, model = small("MOL")
    v = variables_of(model, cfg)
    kw = dict(deterministic=True, input_dtype="float16",
              output_dtype="int16", fold_bucket=16)
    mel = np.random.default_rng(0).uniform(0, 1, (80, 20)).astype(np.float32)
    cpu = Generator(cfg, v, device="cpu", **kw)(
        mel, batched=True, target=200, overlap=28, mu_law=False)
    gen = Generator(cfg, v, device=cuda_device, **kw)
    n = cuda_decode.decode.launches
    out = gen(mel, batched=True, target=200, overlap=28, mu_law=False)
    assert cuda_decode.decode.launches == n + 1
    assert out.dtype == np.int16 and out.shape == cpu.shape == (19 * 275,)
    lsb = np.abs(out.astype(np.int32) - cpu.astype(np.int32))
    assert np.mean(lsb <= 655) >= 0.95
