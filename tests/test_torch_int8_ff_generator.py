"""int8_ff's width policy and the Generator's calibrate-once caching
(modeled on ``tests/test_pallas_decode.py``'s int8_ff tests), on the CPU,
where each launch runs the decode kernel's plain version: where the
bounds are calibrated, how often, on which conditioning, and which pack
each launch takes.  The JAX comparisons are in
``tests/test_torch_int8_ff.py``."""

import functools

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.infer.stream_server import StreamServer
from wavernn_tpu_torch.models.wavernn import (
    WaveRNN, WaveRNNConfig, to_jax_variables,
)
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.ops import decode as port_decode
from wavernn_tpu_torch.ops.decode import (
    FF_AUTO_MIN_ROWS, Generator, ff_ranges, int8_ff_policy,
)
from tests.torch_cpu import one_torch_thread  # noqa: F401

TARGET, OVERLAP = 200, 28
# short utterances (frame bucket 8: 1,100 to 3,300 conditioning rows) keep
# each calibration's plain decode short
SERVE = dict(deterministic=True, input_dtype="float16", output_dtype="int16",
             frame_bucket=8)


@functools.lru_cache(maxsize=None)
def small(mode="MOL", seed=0):
    """A seeded small port model (rnn 64) as the JAX config's kwargs and
    the JAX-layout weights both packages load (no JAX init compiles)."""
    kw = dict(rnn_dims=64, fc_dims=64, compute_dims=32, res_out_dims=32,
              res_blocks=2, mode=mode)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = WaveRNN(WaveRNNConfig(**kw)).eval()
    return kw, to_jax_variables(model)


def mel(T, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (80, T)).astype(
        np.float32)


@pytest.fixture()
def launches(monkeypatch):
    """Each decode launch as (its rows, whether it took the int8
    feed-forward pack)."""
    seen = []
    real = cuda_decode.decode

    def spy(packed, cond, *a, **k):
        seen.append((cond.shape[0], cuda_decode.is_int8_ff(packed)))
        return real(packed, cond, *a, **k)
    monkeypatch.setattr(cuda_decode, "decode", spy)
    return seen


@pytest.fixture()
def short_calibration(monkeypatch):
    """Calibrate on 256 steps: the Generator tests check where and how
    often it runs, and a 4,096-step plain decode per Generator would
    dominate their time."""
    monkeypatch.setattr(port_decode, "FF_CAL_STEPS", 256)


# -- the policy ----------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 4, 16, 48, 63, 64, 132, 240])
def test_policy_forces_and_follows_the_h100_crossover(rows):
    """True and False force the variant; None ("auto") turns it on from
    the crossover measured on the H100, not the TPU's 64 rows."""
    assert int8_ff_policy(True, rows) is True
    assert int8_ff_policy(False, rows) is False
    assert int8_ff_policy(None, rows) is (
        FF_AUTO_MIN_ROWS is not None and rows >= FF_AUTO_MIN_ROWS)


# -- the Generator -------------------------------------------------------

def test_calibration_is_eager_and_cached(launches, short_calibration):
    """A forced Generator calibrates once, in ``submit``, on the first
    utterance's conditioning; every later launch takes the same int8
    pack, and the streaming front-end reuses the cache."""
    kw, v = small("MOL")
    gen = Generator(WaveRNNConfig(**kw), v, device="cpu", int8_ff=True,
                    fold_bucket=4, **SERVE)
    assert gen.ff_scales is None and gen.packed_ff is None
    staged = gen.prestage(mel(6, 3), batched=True, target=TARGET,
                          overlap=OVERLAP)
    handle = gen.submit(staged, batched=True, target=TARGET, overlap=OVERLAP,
                        mu_law=False)
    ffs = gen.ff_scales
    assert ffs.shape == (3,) and bool((ffs > 0).all())
    assert cuda_decode.is_int8_ff(gen.packed_ff)
    assert not cuda_decode.is_int8_ff(gen.packed)
    # the bounds of that utterance's packed conditioning, seed 17
    mels_up, aux_mel = gen.model.upsample_parts(
        gen._ingress_f32(staged.mels_dev))
    want = ff_ranges(gen.weights, cuda_decode.pack_stream(
        mels_up, aux_mel, gen.cfg.total_scale), "MOL", gen.cfg.n_classes,
        torch.Generator().manual_seed(17))
    torch.testing.assert_close(ffs, want, rtol=0, atol=0)
    gen.collect(handle)
    gen.collect_batch(gen.submit_batch([mel(4, 5), mel(5, 6)],
                                       target=TARGET, overlap=OVERLAP,
                                       mu_law=False))
    list(gen.stream(mel(5, 7), target=TARGET, overlap=OVERLAP,
                    mu_law=False, group=8))
    assert gen.ff_scales is ffs
    assert launches and all(ff for _, ff in launches)


def test_off_and_scan_never_calibrate(launches, short_calibration):
    kw, v = small("RAW")
    cfg = WaveRNNConfig(**kw)
    off = Generator(cfg, v, device="cpu", int8_ff=False, **SERVE)
    off(mel(4), batched=True, target=TARGET, overlap=OVERLAP, mu_law=True)
    off.collect_batch(off.submit_batch([mel(4), mel(5)], target=TARGET,
                                       overlap=OVERLAP, mu_law=True))
    assert off.ff_scales is None and launches
    assert not any(ff for _, ff in launches)
    scan = Generator(cfg, v, device="cpu", backend="scan", int8_ff=True,
                     **SERVE)
    scan(mel(4), batched=True, target=TARGET, overlap=OVERLAP, mu_law=True)
    assert scan.ff_scales is None and scan.packed is None


def test_update_variables_drops_the_bounds(short_calibration):
    """A weight swap drops the bounds and the int8 pack (the reference
    keeps its stale bounds); the next launch calibrates on the new
    weights."""
    kw, v = small("MOL")
    _, v2 = small("MOL", seed=1)
    gen = Generator(WaveRNNConfig(**kw), v, device="cpu", int8_ff=True,
                    **SERVE)
    m = mel(4, 2)
    gen(m, batched=True, target=TARGET, overlap=OVERLAP, mu_law=False)
    old = gen.ff_scales
    gen.update_variables(v2)
    assert gen.ff_scales is None and gen.packed_ff is None
    gen(m, batched=True, target=TARGET, overlap=OVERLAP, mu_law=False)
    fresh = Generator(WaveRNNConfig(**kw), v2, device="cpu", int8_ff=True,
                      **SERVE)
    fresh(m, batched=True, target=TARGET, overlap=OVERLAP, mu_law=False)
    torch.testing.assert_close(gen.ff_scales, fresh.ff_scales, rtol=0,
                               atol=0)
    assert not torch.equal(gen.ff_scales, old)


def test_auto_stream_calibrates_at_its_first_wide_group(
        monkeypatch, launches, short_calibration):
    """Under "auto" a stream calibrates lazily, at the first group the
    policy turns on; each launch takes the pack its (bucketed) width
    calls for.  Forced, the session calibrates when it opens."""
    monkeypatch.setattr(port_decode, "FF_AUTO_MIN_ROWS", 8)
    kw, v = small("RAW")
    cfg = WaveRNNConfig(**kw)
    gen = Generator(cfg, v, device="cpu", fold_bucket=4, **SERVE)
    m = mel(12, 1)
    kw_s = dict(target=TARGET, overlap=OVERLAP, mu_law=True)
    list(gen.stream(m, group=4, **kw_s))
    assert gen.ff_scales is None and not any(ff for _, ff in launches)
    launches.clear()
    list(gen.stream(m, group=8, first_group=4, **kw_s))
    assert all(ff == (rows >= 8) for rows, ff in launches)
    assert [r for r, _ in launches[:2]] == [4, 8]
    assert gen.ff_scales is not None
    forced = Generator(cfg, v, device="cpu", int8_ff=True, **SERVE)
    forced.open_stream_session(m, TARGET, OVERLAP)
    assert forced.ff_scales is not None


def test_server_calibrates_on_its_first_session(monkeypatch, launches,
                                               short_calibration):
    """A StreamServer launch wide enough under "auto" calibrates on the
    first served session's slot rows, and each launch takes the pack its
    width calls for."""
    monkeypatch.setattr(port_decode, "FF_AUTO_MIN_ROWS", 8)
    kw, v = small("RAW")
    gen = Generator(WaveRNNConfig(**kw), v, device="cpu", fold_bucket=4,
                    **SERVE)
    mels = [mel(f, seed=i) for i, f in enumerate([12, 6])]
    srv = StreamServer(gen, target=TARGET, overlap=OVERLAP, mu_law=True,
                       group=4, width=8, capacity=2, slot_seconds=1.0)
    got = srv.run(mels)
    assert launches[0] == (8, True) and gen.ff_scales is not None
    assert all(ff == (rows >= 8) for rows, ff in launches)
    assert not all(ff for _, ff in launches)
    assert [len(g) for g in got] == [11 * 275, 5 * 275]
    first = gen.open_stream_session(mels[0], TARGET, OVERLAP)
    want = ff_ranges(gen.weights, first.packed, "RAW", gen.cfg.n_classes,
                     torch.Generator().manual_seed(17))
    torch.testing.assert_close(gen.ff_scales, want, rtol=0, atol=0)


def test_a_launch_without_bounds_raises():
    """No fallback: a launch the policy turns on, with no calibrated
    bounds, is an error, never a quiet bf16 launch."""
    kw, v = small("MOL")
    gen = Generator(WaveRNNConfig(**kw), v, device="cpu", int8_ff=True,
                    **SERVE)
    stream = torch.zeros(600, 80 + 32, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="calibrated"):
        gen._decode_rows(stream, np.zeros(4, np.int64), 256, 0)


