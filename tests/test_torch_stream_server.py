"""The port's multi-session ``StreamServer``, against solo streams and the
JAX package's server (mirrors ``tests/test_stream_server.py``).

On the CPU the kernel backend runs the decode kernel's plain version, and
the server's slot buffer lives in host memory.  Small models (rnn 64),
seeded numpy mels, target 200 / overlap 28, deterministic decode.
Tolerances: each session's bytes equal its solo ``Generator.stream``
exactly (a row's decode does not depend on the other rows of its launch);
int16 chunks within 1 LSB of the quantized float stream; the port's server
against the JAX server on ``backend="scan"`` (MOL model, as in
``test_torch_stream.py``), at least 95% of int16 samples within 655 LSB
for the kernel backend and 99% for the port's scan."""

import numpy as np
import pytest

from wavernn_tpu_torch.infer.stream_server import StreamServer
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops.decode import Generator
from tests.test_torch_stream import OVERLAP, TARGET, agreement, mel, small
from tests.torch_cpu import one_torch_thread  # noqa: F401

SERVE = dict(target=TARGET, overlap=OVERLAP, mu_law=True)


@pytest.fixture(scope="module")
def raw():
    return small("RAW")


def gen_of(model, backend="kernel", **kw):
    k, v = model
    return Generator(WaveRNNConfig(**k), v, device="cpu", backend=backend,
                     frame_bucket=16, fold_bucket=4, deterministic=True,
                     **kw)


def solo(gen, mels, group):
    return [np.concatenate(list(gen.stream(m, group=group, **SERVE)))
            for m in mels]


@pytest.mark.parametrize("backend,output_dtype", [
    ("kernel", "float64"), ("scan", "mulaw8")])
def test_server_matches_individual_streams(raw, backend, output_dtype):
    """Three concurrent sessions of different lengths give each one's own
    stream, and share launches."""
    gen = gen_of(raw, backend=backend, output_dtype=output_dtype)
    mels = [mel(f, seed=i) for i, f in enumerate([12, 8, 10])]
    want = solo(gen, mels, group=4)
    srv = StreamServer(gen, group=4, width=12, capacity=4, slot_seconds=1.0,
                       **SERVE)
    got = srv.run(mels)
    spans = sum(-(-len(w) // (TARGET + OVERLAP) // 4) for w in want)
    assert srv.launches < spans
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == gen.output_np_dtype
        np.testing.assert_array_equal(g, w)


def test_server_staggered_add_and_capacity(raw):
    """A session admitted mid-serving still gives its solo stream; at
    capacity ``add`` refuses until a slot frees; the admission errors."""
    gen = gen_of(raw, backend="scan")
    m1, m2 = mel(12, seed=10), mel(9, seed=11)
    solo1, solo2 = solo(gen, [m1, m2], group=2)
    srv = StreamServer(gen, group=2, width=8, capacity=1, **SERVE)
    sid1 = srv.add(m1)
    with pytest.raises(RuntimeError, match="capacity"):
        srv.add(m2)
    got = {sid1: []}
    while sid1 in srv.active:
        for sid, ch in srv.step().items():
            got[sid].append(ch)
    sid2 = srv.add(m2)
    got[sid2] = []
    while srv.active:
        for sid, ch in srv.step().items():
            got[sid].append(ch)
    assert srv.step() == {}
    np.testing.assert_array_equal(np.concatenate(got[sid1]), solo1)
    np.testing.assert_array_equal(np.concatenate(got[sid2]), solo2)
    with pytest.raises(ValueError, match="too short"):
        srv.add(mel(1))
    kernel = StreamServer(gen_of(raw), group=2, width=8, capacity=2,
                          slot_seconds=0.2, **SERVE)
    with pytest.raises(ValueError, match="slot"):
        kernel.add(mel(20))
    kernel.add(mel(4))
    kernel.add(mel(4))
    assert kernel._free_slots == []
    kernel.reset()
    assert kernel.active == [] and sorted(kernel._free_slots) == [0, 1]


def test_server_least_progress_scheduling(raw):
    """A late-joining session is served ahead of one that has made
    progress."""
    srv = StreamServer(gen_of(raw, backend="scan"), group=2, width=2,
                       capacity=2, **SERVE)
    srv.add(mel(12, seed=0))
    srv.step()
    srv.add(mel(12, seed=1))
    items, used = srv._schedule()
    assert items[0][0].sid == 1 and used == 2


def test_int16_stream_matches_quantized_float(raw):
    """int16 chunks (device crossfade, global tail fade, quantization) are
    the float stream quantized, to 1 LSB, from the stream and from the
    server."""
    mels = [mel(f, seed=i) for i, f in enumerate([10, 7])]
    f64 = solo(gen_of(raw, backend="scan"), mels, group=2)
    gen = gen_of(raw, backend="scan", output_dtype="int16")
    i16 = solo(gen, mels, group=2)
    for a, b in zip(i16, f64):
        assert a.dtype == np.int16 and a.shape == b.shape
        expect = np.round(np.clip(b * 32767.0, -32768, 32767))
        assert np.abs(a - expect).max() <= 1.0
        assert np.mean(a == expect) > 0.99
    srv = StreamServer(gen, group=2, width=8, capacity=4, **SERVE)
    for got, want in zip(srv.run(mels), i16):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_server_matches_jax_server(backend):
    from wavernn_tpu.infer.stream_server import StreamServer as JaxServer
    from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
    from wavernn_tpu.ops.decode import Generator as JaxGenerator

    k, v = small("MOL")
    serve = dict(frame_bucket=16, fold_bucket=4, deterministic=True,
                 output_dtype="int16")
    mels = [mel(f, seed=20 + i) for i, f in enumerate([11, 7, 9])]
    kw = dict(group=4, width=12, capacity=2, **SERVE)
    jax_srv = JaxServer(JaxGenerator(JaxConfig(**k), v, backend="scan",
                                     **serve), **kw)
    want = jax_srv.run(mels)
    srv = StreamServer(Generator(WaveRNNConfig(**k), v, device="cpu",
                                 backend=backend, **serve),
                       slot_seconds=1.0, **kw)
    got = srv.run(mels)
    assert srv.launches == jax_srv.launches
    for g, w, m in zip(got, want, mels):
        assert g.shape == w.shape == ((m.shape[1] - 1) * 275,)
        assert agreement(g, w) >= (0.95 if backend == "kernel" else 0.99)
