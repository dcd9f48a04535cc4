"""The whole copy-synthesis slice, port against JAX.

The JAX ``Generator(backend="pallas")`` runs its decode kernel in interpret
mode (``pallas_decode.decode`` patched to ``interpret=True`` in this test
only); the port's ``Generator`` runs on the CPU, where its decode wrapper
takes the kernel's plain PyTorch version.  Same weights, same mel (numpy,
seeded), f16 ingress, int16 egress, deterministic decode, a small model
and target 200 / overlap 28.  They must agree in length and dtype, and at
least 95% of the int16 samples within 655 LSB (2% of full scale): bf16
products are exact on both sides; the port sums them in float64, the
Pallas kernel in float32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.models.wavernn import WaveRNN as JaxWaveRNN
from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu.ops import pallas_decode
from wavernn_tpu.ops.decode import Generator as JaxGenerator
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops.decode import Generator, Prestaged
from tests.torch_cpu import one_torch_thread  # noqa: F401

TARGET, OVERLAP = 200, 28


def small(mode="MOL", seed=0):
    kw = dict(rnn_dims=64, fc_dims=64, compute_dims=32, res_out_dims=32,
              res_blocks=2, mode=mode)
    v = JaxWaveRNN(JaxConfig(**kw)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 275)),
        jnp.zeros((1, 5, 80)), True)
    return kw, jax.tree_util.tree_map(np.asarray, v)


def mel(T, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (80, T)).astype(
        np.float32)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pallas_decode, "decode", functools.partial(
        pallas_decode.decode, interpret=True))


SERVE = dict(deterministic=True, input_dtype="float16",
             output_dtype="int16")


@pytest.mark.parametrize("mode,T_mel", [("MOL", 20), ("RAW", 9)])
def test_generator_matches_jax_pallas(interpret_pallas, mode, T_mel):
    kw, v = small(mode)
    m = mel(T_mel)
    jgen = JaxGenerator(JaxConfig(**kw), v, backend="pallas", **SERVE)
    want = jgen(m, batched=True, target=TARGET, overlap=OVERLAP,
                mu_law=True)
    gen = Generator(WaveRNNConfig(**kw), v, device="cpu", **SERVE)
    got = gen(m, batched=True, target=TARGET, overlap=OVERLAP, mu_law=True)
    assert got.dtype == want.dtype == np.int16
    assert got.shape == want.shape == ((T_mel - 1) * 275,)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert np.mean(d <= 655) >= 0.95, np.mean(d <= 655)
    assert np.std(got.astype(np.float64)) > 0


def test_generator_pipeline_matches_jax_float_unbatched(interpret_pallas):
    """The unbatched path (one row over the whole utterance) and float
    egress with the host tail fade."""
    kw, v = small("MOL")
    m = mel(6, seed=1)
    jgen = JaxGenerator(JaxConfig(**kw), v, backend="pallas",
                        deterministic=True, output_dtype="float32")
    want = jgen(m, batched=False, target=TARGET, overlap=OVERLAP,
                mu_law=False)
    gen = Generator(WaveRNNConfig(**kw), v, device="cpu",
                    deterministic=True, output_dtype="float32")
    got = gen(m, batched=False, target=TARGET, overlap=OVERLAP, mu_law=False)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (5 * 275,)
    assert np.mean(np.abs(got - want) <= 2e-2) >= 0.95


def test_submit_collect_and_generate_batch():
    """prestage/submit/prefetch/collect give what __call__ gives, the
    kernel backend agrees with the f32 scan backend, and generate_batch
    serves each utterance with its own seed stream."""
    kw, v = small("MOL")
    cfg = WaveRNNConfig(**kw)
    gen = Generator(cfg, v, device="cpu", fold_bucket=16, **SERVE)
    mels = [mel(12, seed=s) for s in range(3)]
    staged = [gen.prestage(x, batched=True, target=TARGET, overlap=OVERLAP)
              for x in mels]
    assert isinstance(staged[0], Prestaged)
    assert staged[0].mels_dev.dtype == torch.float16
    handles = [gen.submit(s, batched=True, target=TARGET, overlap=OVERLAP,
                          mu_law=False) for s in staged]
    for h in handles:
        gen.prefetch(h)
    outs = [gen.collect(h) for h in handles]
    for x, o in zip(mels, outs):
        assert o.dtype == np.int16 and o.shape == ((x.shape[1] - 1) * 275,)
        np.testing.assert_array_equal(
            o, gen(x, batched=True, target=TARGET, overlap=OVERLAP,
                   mu_law=False))
    batch = gen.generate_batch(mels, target=TARGET, overlap=OVERLAP,
                               mu_law=False)
    for a, b in zip(batch, outs):    # deterministic: seeds do not matter
        np.testing.assert_array_equal(a, b)
    scan = Generator(cfg, v, device="cpu", backend="scan", fold_bucket=16,
                     **SERVE)
    ref = scan(mels[0], batched=True, target=TARGET, overlap=OVERLAP,
               mu_law=False)
    d = np.abs(ref.astype(np.int32) - outs[0].astype(np.int32))
    assert np.mean(d <= 655) >= 0.95


def test_padding_folds_are_masked():
    """Folds past the real count (fold_bucket padding) decode real stream
    rows but contribute nothing: the output does not depend on the
    bucket."""
    kw, v = small("MOL")
    cfg = WaveRNNConfig(**kw)
    m = mel(12, seed=4)
    outs = [Generator(cfg, v, device="cpu", fold_bucket=fb, **SERVE)(
        m, batched=True, target=TARGET, overlap=OVERLAP, mu_law=False)
        for fb in (1, 16)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_pcm16_fade_and_clip():
    from wavernn_tpu_torch.ops.decode import fade_and_pack

    y = torch.tensor([2.0, -2.0, 0.5, 0.5, 0.5, 0.5])
    out = fade_and_pack(y, wave_len=4, fade=2).numpy()
    # clip after scaling keeps -32768 reachable; the fade covers the last
    # two real samples (1 -> 0) and zeroes what lies past wave_len
    np.testing.assert_array_equal(out, [32767, -32768, 16384, 0, 0, 0])
    short = fade_and_pack(torch.ones(3), wave_len=3, fade=550).numpy()
    np.testing.assert_array_equal(short, [32767, 16384, 0])
    # a window that starts at waveform sample 2 takes its slice of the
    # same envelope
    np.testing.assert_array_equal(
        fade_and_pack(y[2:], wave_len=4, fade=2, base=2).numpy(), out[2:])


def test_cuda_generator_raises_without_cuda(monkeypatch):
    kw, v = small("MOL")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(WaveRNNConfig(**kw), v, device="cuda")


@pytest.mark.parametrize("option,exc", [
    (dict(input_dtype="int16"), ValueError),   # not a wire format
    (dict(mesh=object()), ValueError),          # not a parallel.MeshPlan
    (dict(output_dtype="int8"), ValueError),
    (dict(backend="pallas"), ValueError),
])
def test_unported_options_raise(option, exc):
    kw, v = small("MOL")
    with pytest.raises(exc):
        Generator(WaveRNNConfig(**kw), v, device="cpu", **option)


@pytest.mark.parametrize("option", [
    dict(input_dtype="bfloat16"), dict(input_dtype="uint8"),
    dict(output_dtype="mulaw8"),
])
def test_wire_options_serve(option):
    """The wire formats that once raised construct and serve a short mel:
    the right dtype and length, and not silence."""
    kw, v = small("MOL")
    gen = Generator(WaveRNNConfig(**kw), v, device="cpu",
                    deterministic=True, **option)
    out = gen(mel(6, seed=2), batched=True, target=TARGET, overlap=OVERLAP,
              mu_law=False)
    want = np.uint8 if option.get("output_dtype") == "mulaw8" else np.float64
    assert out.dtype == want and out.shape == (5 * 275,)
    assert np.ptp(out.astype(np.float64)) > 0


def test_prestaged_geometry_mismatch_raises():
    kw, v = small("RAW")
    gen = Generator(WaveRNNConfig(**kw), v, device="cpu", frame_bucket=8)
    staged = gen.prestage(mel(8), batched=True, target=550, overlap=275)
    with pytest.raises(ValueError, match="re-prestage"):
        gen.submit(staged, batched=True, target=1100, overlap=275,
                   mu_law=True)
