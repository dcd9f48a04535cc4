"""The port's serving demo against the JAX example (``examples/
serving_demo.py``): section 4's ``StreamServer`` (group 2, width 8,
capacity 4, deterministic decode) over the JAX example's ``tiny_models()``
weights, carried across (``models/tacotron.py::from_jax_variables`` inside
``TTSGenerator``, ``models/wavernn.py::from_jax_variables`` inside
``Generator``), against the JAX ``StreamServer`` over
``Generator(backend="scan", deterministic=True)`` on the same mels: the
port's Tacotron (plain decoder) makes them from the three demo texts, cut
to 10 frames, folds of 200 + 2 x 28 samples.  Tolerance: the
deterministic-decode tests' (``tests/test_torch_stream_server.py``): at
least 95% of samples within 655 LSB of 16-bit PCM for the kernel backend
(the demo's; its plain version here), and the same launch count as JAX's
server."""

import jax
import numpy as np
import pytest

from wavernn_tpu_torch.examples import serving_demo
from wavernn_tpu_torch.infer.tacotron import TTSGenerator
from wavernn_tpu_torch.models.tacotron import TacotronConfig
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.text import text_to_sequence
from tests.jax_examples import JittedInit, jax_example
from tests.torch_cpu import one_torch_thread  # noqa: F401

TARGET, OVERLAP, FRAMES = 200, 28, 10
LSB = 655 / 32768


@pytest.fixture(scope="module")
def jax_demo():
    ex = jax_example("serving_demo")
    tts, voc = ex.Tacotron, ex.WaveRNN
    ex.Tacotron = lambda cfg: JittedInit(tts(cfg))
    ex.WaveRNN = lambda cfg: JittedInit(voc(cfg))
    tts_cfg, tts_vars, voc_cfg, voc_vars = ex.tiny_models()
    return ex, tts_cfg, jax.device_get(tts_vars), voc_cfg, \
        jax.device_get(voc_vars)


def test_server_matches_jax_server(jax_demo):
    from wavernn_tpu.infer.stream_server import StreamServer as JaxServer
    from wavernn_tpu.ops.decode import Generator as JaxGenerator

    ex, jax_tts_cfg, tts_vars, jax_voc_cfg, voc_vars = jax_demo
    tts_cfg, _, voc_cfg, _ = serving_demo.tiny_models()
    assert tts_cfg == TacotronConfig(**{
        k: getattr(jax_tts_cfg, k) for k in tts_cfg.__dataclass_fields__})
    assert voc_cfg == WaveRNNConfig(**{
        k: getattr(jax_voc_cfg, k) for k in voc_cfg.__dataclass_fields__})
    tts = TTSGenerator(tts_cfg, tts_vars, "cpu", steps=FRAMES)
    mels = [np.clip((tts(text_to_sequence(t, serving_demo.CLEANERS),
                         r=serving_demo.R)[1] + 4) / 8, 0, 1)
            for t in serving_demo.TEXTS]
    assert [m.shape for m in mels] == [(80, FRAMES)] * 3

    det = Generator(voc_cfg, voc_vars, device="cpu", deterministic=True)
    served, _, launches = serving_demo.serve_sessions(det, mels, TARGET,
                                                      OVERLAP)
    jax_srv = JaxServer(JaxGenerator(jax_voc_cfg, voc_vars, backend="scan",
                                     deterministic=True),
                        target=TARGET, overlap=OVERLAP, mu_law=True,
                        **serving_demo.SERVER)
    want = jax_srv.run(mels)
    assert launches == jax_srv.launches
    for g, w in zip(served, want):
        assert g.shape == w.shape == ((FRAMES - 1) * 275,)
        agree = float(np.mean(np.abs(g - np.asarray(w, np.float64)) <= LSB))
        assert agree >= 0.95, (agree, np.abs(g - np.asarray(w)).max())
