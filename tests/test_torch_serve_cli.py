"""The port's serving daemon entry (``python -m wavernn_tpu_torch.serve``).

``serve.setup`` on ``--device cpu`` with the committed tiny golden
Tacotron and tiny RAW golden WaveRNN and an hp file with their dims
(target 200 / overlap 28), bound to port 0 and warmed up: ``/health``
answers and ``/synthesize`` returns a WAV of (frames - 1) * hop samples,
frames being those of the same text through the port's ``TTSGenerator``.
Without CUDA the default device (``cuda``) must fail rather than fall
back, and so must ``--mesh`` over the default devices (every visible CUDA
device) on ``--device cpu``; ``--mesh --mesh_devices cpu,cpu`` serves the
bytes the meshless daemon serves."""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from wavernn_tpu_torch import serve
from wavernn_tpu_torch.config import hp
from tests.test_torch_cli import GOLDEN, TACO, WEIGHTS
from tests.test_torch_cli import tts_args  # noqa: F401 — fixture
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.fixture()
def serve_argv(tts_args, tmp_path):  # noqa: F811
    """argv for the tiny goldens: the TTS CLI test's hp file (tiny
    Tacotron and RAW WaveRNN dims) with a short fold geometry."""
    hp_file = tts_args[tts_args.index("--hp_file") + 1]
    with open(hp_file, "a") as f:
        f.write("voc_target = 200\nvoc_overlap = 28\n")
    yield ["--hp_file", hp_file, "--tts_weights", str(TACO),
           "--voc_weights", str(WEIGHTS), "--port", "0", "--slot_seconds",
           "2", "--deterministic"]
    hp.reset()


def test_serve_setup_answers_on_cpu(serve_argv):
    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.models.tacotron import TacotronConfig
    from wavernn_tpu_torch.text import text_to_sequence
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    service, httpd = serve.setup(serve.parse_args(serve_argv
                                                  + ["--device", "cpu"]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
        assert health["ok"] is True and health["sample_rate"] == 22050
        assert health["served_sessions"] == 2        # the warm-up's two
        conn.request("POST", "/synthesize",
                     body=json.dumps({"text": "abcdeabcde"}).encode())
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    assert resp.status == 200 and resp.getheader("Content-Type") == "audio/wav"
    pcm = np.frombuffer(body[44:], "<i2")
    blob = load_pytree(TACO)
    meta = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())
    mel, _, _ = TTSGenerator(TacotronConfig(**meta["dims"]),
                             {"params": blob["params"],
                              "batch_stats": blob["batch_stats"]},
                             "cpu")(text_to_sequence("abcdeabcde",
                                                     ["english_cleaners"]),
                                    r=2)
    assert pcm.shape == ((mel.shape[1] - 1) * 275,)
    assert np.abs(pcm.astype(np.int32)).max() > 0


def test_serve_mesh_answers_as_without(serve_argv):
    """``--mesh --mesh_devices cpu,cpu``: the pipeline's vocoder shards
    its launches over the two-shard mesh, and ``/synthesize`` answers with
    the bytes of the meshless daemon (deterministic)."""
    bodies = []
    for extra in ([], ["--mesh", "--mesh_devices", "cpu,cpu"]):
        service, httpd = serve.setup(serve.parse_args(
            serve_argv + ["--device", "cpu", "--no_warmup"] + extra))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            mesh = service.server.pipeline.voc.mesh
            assert (mesh is None) == (not extra)
            assert extra == [] or mesh.n_data == 2
            conn = http.client.HTTPConnection(
                "127.0.0.1", httpd.server_address[1], timeout=60)
            conn.request("POST", "/synthesize",
                         body=json.dumps({"text": "abcde"}).encode())
            resp = conn.getresponse()
            assert resp.status == 200
            bodies.append(resp.read())
            conn.close()
        finally:
            httpd.shutdown()
            httpd.server_close()
            service.close()
        hp.reset()
    assert len(bodies[0]) > 1000 and bodies[1] == bodies[0]


def test_serve_fails_without_cuda_and_refuses_mesh(serve_argv, monkeypatch):
    """A mesh it cannot build is refused: ``--mesh`` takes every visible
    CUDA device unless ``--mesh_devices`` lists others, and never the CPU
    unasked; ``--mesh_devices`` without ``--mesh`` is a wrong plan."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.setup(serve.parse_args(serve_argv + ["--device", "cpu",
                                                   "--mesh"]))
    hp.reset()
    with pytest.raises(ValueError, match="needs --mesh"):
        serve.setup(serve.parse_args(serve_argv + [
            "--device", "cpu", "--mesh_devices", "cpu,cpu"]))
    hp.reset()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.setup(serve.parse_args(serve_argv))
