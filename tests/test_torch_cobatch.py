"""Co-batched serving and the wire formats of the port's ``Generator``,
against the JAX package.

The JAX ``Generator(backend="pallas")`` runs its decode kernel in interpret
mode (patched in this test only); the port runs on the CPU, where its
decode wrapper takes the kernel's plain version.  A small model (rnn 64),
seeded numpy mels, target 200 / overlap 28, deterministic decode.
Tolerances: the port against JAX, at least 95% of int16 samples within 655
LSB (2% of full scale), as ``test_torch_generator.py`` holds the
one-utterance path (bf16 products are exact on both sides; the port sums
them in float64, the Pallas kernel in float32); a co-batched utterance
against its solo submit, at least 99% within 655 LSB (the batched
upsample may round differently); int16 against the float path to 1 LSB;
mulaw8 within 1 label of ``dsp.audio.encode_mu_law`` of the float path;
uint8 ingress bit-equal to float32 ingress of the requantized mel;
bfloat16 ingress bit-equal to JAX's cast on the host."""

import functools

import numpy as np
import pytest
import torch

from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu.ops import pallas_decode
from wavernn_tpu.ops.decode import Generator as JaxGenerator
from wavernn_tpu_torch.dsp import audio
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops.decode import Generator, PrestagedBatch
from tests.test_torch_stream import small
from tests.torch_cpu import one_torch_thread  # noqa: F401

TARGET, OVERLAP = 200, 28
FRAMES = (20, 9, 14)


def mels(frames=FRAMES, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (80, t)).astype(np.float32) for t in frames]


def lsb_agreement(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.int16
    return float(np.mean(np.abs(a.astype(np.int32) - b.astype(np.int32))
                         <= 655))


@pytest.fixture(scope="module")
def model():
    """A seeded small model (rnn 64) as the JAX Config's kwargs and the
    JAX-layout weights both packages load."""
    return small("MOL")


def port(model, **kw):
    k, v = model
    kw = {"deterministic": True, "fold_bucket": 16, **kw}
    return Generator(WaveRNNConfig(**k), v, device="cpu", **kw)


def test_cobatched_matches_jax_and_solo(model, monkeypatch):
    monkeypatch.setattr(pallas_decode, "decode", functools.partial(
        pallas_decode.decode, interpret=True))
    k, v = model
    kw = dict(deterministic=True, input_dtype="float16",
              output_dtype="int16")
    batch = mels()
    jgen = JaxGenerator(JaxConfig(**k), v, backend="pallas", **kw)
    want = jgen.generate_batch(
        jgen.prestage_batch(batch, TARGET, OVERLAP), target=TARGET,
        overlap=OVERLAP, mu_law=False)
    gen = port(model, **kw)
    staged = gen.prestage_batch(batch, TARGET, OVERLAP)
    assert isinstance(staged, PrestagedBatch)
    assert staged.batch_dev.dtype == torch.float16
    cond, T = gen.batch_conditioning(staged)
    assert T == TARGET + 2 * OVERLAP and cond.dtype == torch.bfloat16
    assert cond.shape == (gen._pad_folds(sum(staged.fold_counts)), T, 112)
    got = gen.generate_batch(staged, target=TARGET, overlap=OVERLAP,
                             mu_law=False)
    solo = [gen(m, batched=True, target=TARGET, overlap=OVERLAP,
                mu_law=False) for m in batch]
    for g, w, s, m in zip(got, want, solo, batch):
        assert g.shape == ((m.shape[1] - 1) * 275,)
        assert lsb_agreement(g, w) >= 0.95
        assert lsb_agreement(g, s) >= 0.99
        assert np.std(g.astype(np.float64)) > 0


def test_cobatched_int16_matches_float(model):
    batch = mels(seed=1)
    f = port(model).generate_batch(
        port(model).prestage_batch(batch, TARGET, OVERLAP), TARGET, OVERLAP,
        mu_law=False)
    gen = port(model, output_dtype="int16")
    handle = gen.submit_batch(batch, TARGET, OVERLAP, mu_law=False)
    gen.prefetch_batch(handle)
    pcm = gen.collect_batch(handle)
    for w16, w64 in zip(pcm, f):
        assert w16.dtype == np.int16 and w16.shape == w64.shape
        expect = np.round(np.clip(w64, -1, 1) * 32767.0)
        assert np.abs(w16 - expect).max() <= 1.0
        assert np.mean(w16 == expect) > 0.99


def test_stale_batch_geometry_raises(model):
    gen = port(model)
    staged = gen.prestage_batch(mels((9, 10)), TARGET, OVERLAP)
    with pytest.raises(ValueError, match="re-prestage"):
        gen.submit_batch(staged, target=TARGET + 100, overlap=OVERLAP,
                         mu_law=False)


@pytest.mark.parametrize("cobatch", [False, True],
                         ids=["one_utterance", "cobatched"])
def test_uint8_ingress_bit_exact(model, cobatch):
    batch = mels((12, 7), seed=3)
    q = [(np.clip(np.round(m * 255.0), 0.0, 255.0)
          * np.float32(1.0 / 255.0)).astype(np.float32) for m in batch]
    lean, ref = port(model, input_dtype="uint8"), port(model)
    geom = dict(target=TARGET, overlap=OVERLAP, mu_law=False)
    if cobatch:
        got = lean.generate_batch(lean.prestage_batch(batch, TARGET,
                                                      OVERLAP), **geom)
        want = ref.generate_batch(ref.prestage_batch(q, TARGET, OVERLAP),
                                  **geom)
    else:
        got = [lean(m, batched=True, **geom) for m in batch]
        want = [ref(m, batched=True, **geom) for m in q]
    assert lean.prestage(batch[0], True, TARGET,
                         OVERLAP).mels_dev.dtype == torch.uint8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mulaw8_within_one_label(model):
    batch = mels((16, 11), seed=4)
    geom = dict(target=TARGET, overlap=OVERLAP, mu_law=False)
    f64 = port(model).generate_batch(
        port(model).prestage_batch(batch, TARGET, OVERLAP), **geom)
    gm = port(model, output_dtype="mulaw8")
    wm = gm.generate_batch(gm.prestage_batch(batch, TARGET, OVERLAP),
                           **geom)
    wm.append(gm(batch[0], batched=True, **geom))
    f64.append(port(model)(batch[0], batched=True, **geom))
    for w8, w64 in zip(wm, f64):
        assert w8.dtype == np.uint8 and w8.shape == w64.shape
        expect = audio.encode_mu_law(np.clip(w64, -1, 1), 256)
        d = np.abs(w8.astype(np.float64) - expect)
        assert d.max() <= 1.0 and np.mean(d == 0) > 0.99
        assert np.ptp(w8) > 0


def test_bfloat16_ingress_matches_jax_cast(model):
    k, v = model
    m = mels((13,), seed=5)[0]
    m[0, :4] = [1 / 3, 0.5 + 2 ** -9, 0.5 + 3 * 2 ** -9, 1.0]  # ties, RNE
    jgen = JaxGenerator(JaxConfig(**k), v, backend="scan",
                        input_dtype="bfloat16")
    gen = port(model, input_dtype="bfloat16")
    padded, _, _ = gen._pad_mel(m)
    want = np.asarray(jgen._ingress_pack(padded)).view(np.uint16)
    got = gen._ingress_pack(padded)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want)
    out = gen(m, batched=True, target=TARGET, overlap=OVERLAP, mu_law=False)
    assert out.shape == (12 * 275,) and np.ptp(out) > 0
