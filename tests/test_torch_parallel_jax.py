"""The port's mesh paths against the JAX package's on the CPU: the
deterministic ``Generator(mesh=)`` (scan backend) against JAX's
``Generator(mesh=make_mesh())`` on the 8 virtual CPU devices of
``tests/conftest.py`` within 1e-5, as ``tests/test_parallel.py`` holds JAX
to itself, and ``TTSGenerator(mesh=).batch`` against JAX's within 1e-4
(B=3 on 8 shards: both pad the utterance axis).  Each side shards over 8
devices, JAX over its virtual ones and the port over ``["cpu"] * 8``.  The
weights are seeded port models in the JAX layout, so no JAX init
compiles."""

import numpy as np
import torch

from wavernn_tpu.infer.tacotron import TTSGenerator as JaxTTSGenerator
from wavernn_tpu.models.tacotron import TacotronConfig as JaxTacotronConfig
from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu.ops.decode import Generator as JaxGenerator
from wavernn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wavernn_tpu_torch.infer.tacotron import TTSGenerator
from wavernn_tpu_torch.models.tacotron import TacotronConfig, init_variables
from wavernn_tpu_torch.models.wavernn import (
    WaveRNN, WaveRNNConfig, to_jax_variables,
)
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.parallel.mesh import make_mesh
from tests.torch_cpu import one_torch_thread  # noqa: F401

CPU8 = ["cpu"] * 8
VOC = dict(rnn_dims=32, fc_dims=32, bits=8, pad=2, upsample_factors=(2, 2),
           feat_dims=8, compute_dims=8, res_out_dims=8, res_blocks=1,
           hop_length=4, sample_rate=1000, mode="RAW")
TTS = dict(embed_dims=16, num_chars=148, encoder_dims=16, decoder_dims=32,
           n_mels=20, fft_bins=20, postnet_dims=16, encoder_K=4,
           lstm_dims=32, postnet_K=3, num_highways=2)


def test_generator_mesh_matches_jax_mesh():
    """tests/test_parallel.py's Generator case (mel of 40 frames, target 16
    / overlap 8, mu-law) through both packages' sharded scan decoders."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        v = to_jax_variables(WaveRNN(WaveRNNConfig(**VOC)))
    mel = np.random.default_rng(3).uniform(0, 1, (8, 40)).astype(np.float32)
    geom = dict(batched=True, target=16, overlap=8, mu_law=True)
    want = JaxGenerator(JaxConfig(**VOC), v, backend="scan",
                        mesh=jax_make_mesh(), deterministic=True)(mel, **geom)
    gen = Generator(WaveRNNConfig(**VOC), v, "cpu", backend="scan",
                    mesh=make_mesh(devices=CPU8), deterministic=True)
    got = gen(mel, **geom)
    assert gen._pad_folds(3) == 8 and got.shape == want.shape
    assert np.std(want) > 0
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_tts_batch_mesh_matches_jax_mesh():
    cfg = JaxTacotronConfig(**TTS)
    v = init_variables(TacotronConfig(**TTS), 0)
    rng = np.random.default_rng(5)
    seqs = [list(rng.integers(1, 140, n)) for n in (5, 8, 6)]
    want = JaxTTSGenerator(cfg, v, steps=20, text_bucket=8, backend="xla",
                           mesh=jax_make_mesh()).batch(seqs, r=5)
    got = TTSGenerator(TacotronConfig(**TTS), v, "cpu", steps=20,
                       text_bucket=8, mesh=make_mesh(devices=CPU8)
                       ).batch(seqs, r=5)
    assert len(got) == len(want) == 3
    for (gm, gl, ga), (wm, wl, wa) in zip(got, want):
        assert gm.shape == wm.shape and ga.shape == wa.shape
        np.testing.assert_allclose(gm, wm, atol=1e-4)
        np.testing.assert_allclose(gl, wl, atol=1e-4)
        np.testing.assert_allclose(ga, wa, atol=1e-4)
