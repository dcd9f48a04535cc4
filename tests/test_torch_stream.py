"""Streaming synthesis of the port's ``Generator`` (``stream``,
``stream_oneshot``, ``fold_spans``, the incremental crossfade), against
itself and the JAX package.

On the CPU the kernel backend runs the decode kernel's plain version.  A
small RAW model (rnn 64), seeded numpy mels, target 200 / overlap 28,
deterministic decode.  Tolerances: ``stream`` equals ``stream_oneshot``
exactly (the same launches, finalized in one piece or in groups); a
stream against the one-utterance ``submit`` path, whose single launch
holds all folds, at least 99% of int16 samples within 655 LSB (a row's
float64 dots may round differently in a batch of another size on the
CPU; on the card each row has its own CTA); the port's stream against the
JAX stream (JAX on ``backend="scan"``, float32 dots; the MOL model, whose
deterministic sample is a mixture mean: an untrained RAW model's near-flat
512-way argmax flips on bf16 rounding), at least 95% within 655 LSB for
the kernel backend and 99% for the port's float32 scan."""

import numpy as np
import pytest

from wavernn_tpu.ops import decode as jax_decode
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig, to_jax_variables
from wavernn_tpu_torch.ops.decode import Generator, fold_spans
from tests.test_torch_cuda import small as torch_small
from tests.torch_cpu import one_torch_thread  # noqa: F401

TARGET, OVERLAP = 200, 28
STRIDE = TARGET + OVERLAP


def mel(frames, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (80, frames)).astype(
        np.float32)


def small(mode):
    cfg, model = torch_small(mode)
    return (dict(rnn_dims=64, fc_dims=64, compute_dims=32, res_out_dims=32,
                 res_blocks=2, mode=mode), to_jax_variables(model))


@pytest.fixture(scope="module")
def model():
    """A seeded small model (rnn 64) as the JAX Config's kwargs and the
    JAX-layout weights both packages load."""
    return small("RAW")


def port(model, **kw):
    k, v = model
    kw = {"deterministic": True, "fold_bucket": 4, **kw}
    return Generator(WaveRNNConfig(**k), v, device="cpu", **kw)


def agreement(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.int16
    return float(np.mean(np.abs(a.astype(np.int32) - b.astype(np.int32))
                         <= 655))


@pytest.mark.parametrize("needed,group,first", [
    (1, 16, None), (10, 3, None), (10, 3, 1), (10, 16, 4), (33, 32, 4),
    (48, 32, 4), (5, 4, 4), (7, 2, 5)])
def test_fold_spans_match_jax(needed, group, first):
    spans = fold_spans(needed, group, first)
    assert spans == jax_decode.fold_spans(needed, group, first)
    assert spans[0][0] == 0 and spans[-1][1] == needed
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("output_dtype,first_group", [
    ("float64", None), ("int16", 1), ("mulaw8", 2)])
def test_stream_equals_stream_oneshot(model, output_dtype, first_group):
    gen = port(model, output_dtype=output_dtype)
    m = mel(12, seed=1)
    kw = dict(target=TARGET, overlap=OVERLAP, mu_law=True, group=5,
              first_group=first_group)
    chunks = list(gen.stream(m, **kw))
    oneshot = gen.stream_oneshot(m, **kw)
    assert len(chunks) >= 3
    if first_group:
        plain = list(gen.stream(m, **dict(kw, first_group=None)))
        assert len(chunks[0]) < len(plain[0])  # the first chunk is earlier
    got = np.concatenate(chunks)
    assert got.dtype == oneshot.dtype == gen.output_np_dtype
    assert got.shape == oneshot.shape == (11 * 275,)
    np.testing.assert_array_equal(got, oneshot)


def test_streaming_tail_fade_spans_chunk_boundaries(model):
    """The last feed's chunk is shorter than the 20-hop tail fade, so the
    fade must run in waveform coordinates across chunk boundaries, as
    the one-shot paths fade (JAX ``tests/test_wavernn.py``'s regression
    test of the same name)."""
    T_mel, group = 13, 7
    wave_len = (T_mel - 1) * 275
    needed = -(-wave_len // STRIDE)
    assert needed % group == 1 and wave_len - (needed - 1) * STRIDE < 5500
    for output_dtype in ("float64", "int16"):
        gen = port(model, output_dtype=output_dtype)
        m = mel(T_mel, seed=2)
        kw = dict(target=TARGET, overlap=OVERLAP, mu_law=True)
        chunks = list(gen.stream(m, group=group, **kw))
        assert len(chunks[-1]) < 5500     # the fade spans several chunks
        streamed = np.concatenate(chunks)
        oneshot = gen.stream_oneshot(m, group=group, **kw)
        assert streamed.shape == oneshot.shape == (wave_len,)
        np.testing.assert_array_equal(streamed, oneshot)
        # host rows fed in two pieces finalize to the same bytes
        from wavernn_tpu_torch.ops.decode import _IncrementalUnfold

        launch, needed, stride, _ = gen._stream_setup(m, TARGET, OVERLAP, 0)
        rows = launch(0, needed)[0][:needed].numpy()
        fin = _IncrementalUnfold(gen, needed, stride, wave_len, OVERLAP, True)
        fed = np.concatenate([fin.feed(rows[:5]), fin.feed(rows[5:])])
        assert fin.done
        np.testing.assert_array_equal(fed, oneshot)
        whole = gen(m, batched=True, **kw)   # one launch of every fold
        if output_dtype == "int16":
            assert agreement(streamed, whole) >= 0.99
            assert streamed[-1] == 0      # faded to silence
        else:
            np.testing.assert_allclose(streamed, whole, atol=1e-6)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_stream_matches_jax_stream(backend):
    from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig

    k, v = small("MOL")
    m = mel(14, seed=3)
    kw = dict(target=TARGET, overlap=OVERLAP, mu_law=True, group=8,
              first_group=2)
    serve = dict(frame_bucket=16, fold_bucket=4, deterministic=True,
                 output_dtype="int16")
    jgen = jax_decode.Generator(JaxConfig(**k), v, backend="scan", **serve)
    want = np.concatenate(list(jgen.stream(m, **kw)))
    gen = Generator(WaveRNNConfig(**k), v, device="cpu", backend=backend,
                    **serve)
    got = np.concatenate(list(gen.stream(m, **kw)))
    assert got.shape == want.shape == (13 * 275,)
    assert agreement(got, want) >= (0.95 if backend == "kernel" else 0.99)
    assert np.std(got.astype(np.float64)) > 0
