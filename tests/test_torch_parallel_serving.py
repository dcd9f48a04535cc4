"""The stream, the ``StreamServer`` and the int8_ff width policy under a
device mesh, on the CPU without JAX: ``Generator(mesh=make_mesh(devices=
["cpu"] * 4))`` against the meshless Generator, byte for byte in sampling
and in deterministic mode (the seeded MOL model and helpers of
``test_torch_parallel.py``)."""

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.infer.stream_server import StreamServer
from wavernn_tpu_torch.ops import decode as decode_ops
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_parallel import (  # noqa: F401 — models: a fixture
    CPU4, OVERLAP, TARGET, mel, models, pair,
)
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("det", [False, True])
def test_mesh_stream_and_server_are_byte_equal(models, det):
    plain, meshed = pair(models, "MOL", det)
    geom = dict(target=TARGET, overlap=OVERLAP, mu_law=False)
    m = mel(5, seed=2)
    want = list(plain.stream(m, group=4, first_group=1, seed=9, **geom))
    got = list(meshed.stream(m, group=4, first_group=1, seed=9, **geom))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    mels = [mel(5, seed=3), mel(3, seed=4)]
    srv = dict(group=2, width=6, capacity=2, slot_seconds=0.4, seed=1,
               **geom)
    want = StreamServer(plain, **srv).run(mels)
    got = StreamServer(meshed, **srv).run(mels)
    for g, w in zip(got, want):
        assert len(w) > 0 and np.array_equal(g, w)


def test_int8_ff_policy_takes_each_shards_width(models, monkeypatch):
    """The int8_ff width policy reads a shard's rows, not the launch's;
    forced, the variant's mesh output is the meshless one's (one
    calibration per Generator, its pack copied to each device)."""
    monkeypatch.setattr(decode_ops, "FF_AUTO_MIN_ROWS", 3)
    cfg, v = models["MOL"]
    mesh_gen = Generator(cfg, v, "cpu", mesh=make_mesh(devices=CPU4))
    plain_gen = Generator(cfg, v, "cpu")
    assert plain_gen._ff_policy(8) and not mesh_gen._ff_policy(8)
    assert mesh_gen._ff_policy(12) and mesh_gen._ff_policy(2) is False
    plain, meshed = pair(models, "MOL", False, int8_ff=True)
    geom = dict(batched=True, target=TARGET, overlap=OVERLAP, mu_law=False,
                seed=2)
    m = mel(4, seed=6)
    assert np.array_equal(meshed(m, **geom), plain(m, **geom))
    assert torch.equal(meshed.ff_scales, plain.ff_scales)
    assert meshed._on(meshed.packed_ff, torch.device("cpu")) is \
        meshed.packed_ff                       # one device: no copy
