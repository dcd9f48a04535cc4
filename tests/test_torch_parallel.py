"""The port's data parallelism over devices (``wavernn_tpu_torch/parallel``)
on the CPU, without JAX: mesh shapes and their errors (the counterparts of
``tests/test_parallel.py``'s ``test_mesh_shapes`` and
``test_shard_batch_divisibility``), the plan kinds each user takes, the
decode kernel's ``row0`` (its plain version), ``shard_rows``, and
``Generator(mesh=make_mesh(devices=["cpu"] * 4))`` against the meshless
Generator: byte-equal in sampling and in deterministic mode for the
one-shot and the co-batched serve, RAW (the committed tiny golden) and MOL
(a seeded port model).  The stream, the ``StreamServer`` and int8_ff under
a mesh are in ``test_torch_parallel_serving.py``, the JAX comparisons in
``test_torch_parallel_jax.py``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.infer.tacotron import TTSGenerator
from wavernn_tpu_torch.models.tacotron import TacotronConfig
from wavernn_tpu_torch.models.wavernn import (
    WaveRNN, WaveRNNConfig, to_jax_variables,
)
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.parallel.mesh import (
    MeshPlan, concrete_device, make_mesh, shard_batch_fn, shard_rows,
)
from wavernn_tpu_torch.training.state import make_optimizer
from wavernn_tpu_torch.training.tacotron import make_tts_train_step
from wavernn_tpu_torch.training.wavernn import make_train_step
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
TARGET, OVERLAP = 200, 28
CPU4 = ["cpu"] * 4
RAW = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
           res_blocks=2, mode="RAW")
MOL = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
           res_blocks=1, mode="MOL")


def world(n=4, rank=0):
    """A world plan of ``n`` ranks as rank ``rank`` sees it (no process
    group is needed to slice a batch)."""
    return MeshPlan(n_data=n, devices=(torch.device("cpu"),), world=True,
                    rank=rank)


@pytest.fixture(scope="module")
def models():
    blob = load_pytree(GOLDEN / "tiny_wavernn_raw.msgpack")
    raw = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        mol = to_jax_variables(WaveRNN(WaveRNNConfig(**MOL)))
    return {"RAW": (WaveRNNConfig(**RAW), raw),
            "MOL": (WaveRNNConfig(**MOL), mol)}


def mel(T, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (80, T)).astype(
        np.float32)


def test_mesh_shapes(monkeypatch):
    plan = make_mesh(devices=CPU4)
    assert (plan.n_data, plan.n_model, plan.world) == (4, 1, False)
    assert plan.device == torch.device("cpu")
    assert make_mesh({"data": 4, "model": 1}, devices=CPU4).n_data == 4
    with pytest.raises(ValueError, match="does not match"):
        make_mesh({"data": 3}, devices=CPU4)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        make_mesh({"pipe": 4}, devices=CPU4)
    plan = make_mesh({"data": 2, "model": 2}, devices=CPU4)
    assert (plan.n_data, plan.n_model) == (2, 2)
    with pytest.raises(ValueError, match="does not match"):
        make_mesh({"data": 3, "model": 2}, devices=CPU4)
    # a bare "cuda" names the current card, as a tensor's .device does
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert concrete_device("cuda") == torch.device("cuda", 0)
    assert concrete_device("cuda:1") == torch.device("cuda", 1)
    assert concrete_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()                       # never the CPU unasked
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(devices=["cuda:0", "cuda:0"])


def test_shard_batch_divisibility():
    x = np.arange(24).reshape(8, 3)
    for rank in range(4):
        (got,) = shard_batch_fn(world(4, rank))(x)
        assert isinstance(got, torch.Tensor) and got.shape == (2, 3)
        np.testing.assert_array_equal(got.numpy(), x[2 * rank:2 * rank + 2])
    got, = shard_batch_fn(world(4, 3))(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), x[6:])
    assert shard_batch_fn(world()).plan.rank == 0
    with pytest.raises(ValueError, match="divisible"):
        shard_batch_fn(world())(np.zeros((6, 3)))
    with pytest.raises(ValueError, match="torchrun"):
        shard_batch_fn(make_mesh(devices=CPU4))


def test_each_user_takes_its_kind_of_plan(models):
    """Generation takes a local plan, training a world plan; anything else
    is a ValueError naming the right launcher."""
    cfg, v = models["RAW"]
    local = make_mesh(devices=CPU4)
    for bad, word in ((object(), "MeshPlan"), (world(), "local plan")):
        with pytest.raises(ValueError, match=word):
            Generator(cfg, v, "cpu", mesh=bad)
        with pytest.raises(ValueError, match=word):
            shard_rows(bad, lambda x, r: x, torch.zeros(4))
    with pytest.raises(ValueError, match="first device"):
        Generator(cfg, v, "cpu", mesh=make_mesh(devices=["meta", "cpu"]))
    opt = make_optimizer(1e-3, None)
    with pytest.raises(ValueError, match="world plan"):
        make_train_step(opt, "RAW", local)
    tts_cfg = TacotronConfig(embed_dims=8, encoder_dims=8, decoder_dims=16,
                             lstm_dims=16, postnet_dims=8, encoder_K=2,
                             postnet_K=2, num_highways=1)
    with pytest.raises(ValueError, match="world plan"):
        make_tts_train_step(None, opt, 2, local)
    with pytest.raises(ValueError, match="MeshPlan"):
        TTSGenerator(tts_cfg, None, "cpu", mesh="cpu,cpu")


def test_shard_rows_offsets_and_gathers():
    plan = make_mesh(devices=["cpu"] * 3)
    x = torch.arange(12.0).reshape(6, 2)
    seen = []

    def fn(a, b, row0):
        seen.append((row0, a.shape[0]))
        return a + b + 100 * row0

    got = shard_rows(plan, fn, x, 2 * x)
    assert seen == [(0, 2), (2, 2), (4, 2)]
    np.testing.assert_array_equal(
        got.numpy(), 3 * x.numpy() + 100 * np.repeat([0, 2, 4], 2)[:, None])
    with pytest.raises(ValueError, match="split evenly"):
        shard_rows(plan, fn, x[:5], x[:5])


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_decode_row0_draws_the_rows_of_the_whole_launch(models, mode):
    """``row0 = k`` keys the random bits by ``k + row``: rows ``[k, k+b)``
    decoded alone equal those rows of the whole launch, in sampling mode;
    without ``row0`` they would draw other bits."""
    cfg, v = models[mode]
    gen = Generator(cfg, v, "cpu", int8_ff=False)
    C = cfg.feat_dims + cfg.aux_dims * 4
    cond = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (8, 48, C)).astype(np.float32)).to(torch.bfloat16)
    run = lambda c, row0=0: cuda_decode.decode_reference(
        gen.packed, c, 48, 11, cfg.mode, cfg.n_classes, False, row0=row0)
    whole = run(cond)
    for k, b in ((1, 3), (4, 4)):
        part = run(cond[k:k + b].contiguous(), row0=k)
        assert torch.equal(part, whole[k:k + b])
        assert torch.equal(cuda_decode.decode(
            gen.packed, cond[k:k + b].contiguous(), 48, 11, cfg.mode,
            cfg.n_classes, False, row0=k), part)
    assert not torch.equal(run(cond[4:8].contiguous()), whole[4:8])
    bits = cuda_decode.random_bits(3, torch.arange(4), 9, 5, row0=6)
    assert torch.equal(bits, cuda_decode.random_bits(
        3, torch.arange(10), 9, 5)[6:])
    with pytest.raises(ValueError, match="row0"):
        cuda_decode.decode(gen.packed, cond, 48, 11, cfg.mode, cfg.n_classes,
                           False, row0=-1)


SERVE = dict(input_dtype="float16", output_dtype="int16", fold_bucket=2,
             int8_ff=False)


def pair(models, mode, det, **kw):
    cfg, v = models[mode]
    kw = {**SERVE, "deterministic": det, **kw}
    return (Generator(cfg, v, "cpu", **kw),
            Generator(cfg, v, "cpu", mesh=make_mesh(devices=CPU4), **kw))


@pytest.mark.parametrize("mode,det", [("RAW", False), ("MOL", False),
                                      ("MOL", True)])
def test_mesh_oneshot_and_cobatch_are_byte_equal(models, mode, det):
    """One request (6 folds, padded to 8 rows: 2 a shard) and a co-batched
    serve of two (MOL sampling: a raw list given to the mesh Generator's
    ``generate_batch`` is served co-batched, as in the JAX package, and a
    single-row unbatched decode stays on the first device)."""
    plain, meshed = pair(models, mode, det)
    geom = dict(target=TARGET, overlap=OVERLAP, mu_law=False, seed=4)
    m = mel(5)
    want = plain(m, batched=True, **geom)
    assert want.dtype == np.int16 and np.std(want) > 0
    assert np.array_equal(meshed(m, batched=True, **geom), want)
    assert meshed._pad_folds(6) == 8 and plain._pad_folds(6) == 6
    mels = [mel(3, seed=s) for s in range(2)]
    want = plain.generate_batch(
        plain.prestage_batch(mels, TARGET, OVERLAP), **geom)
    got = [meshed.generate_batch(
        meshed.prestage_batch(mels, TARGET, OVERLAP), **geom)]
    if mode == "MOL" and not det:
        got.append(meshed.generate_batch(mels, **geom))
        assert meshed._sharded(8) and not meshed._sharded(1)
    for waves in got:
        for g, w in zip(waves, want):
            assert np.array_equal(g, w)
