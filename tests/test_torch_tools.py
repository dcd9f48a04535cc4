"""The port's kernel-measurement tools (``wavernn_tpu_torch/tools/``) and its
profiling hooks (``wavernn_tpu_torch/utils/profiling.py``) on the CPU.

Each tool's ``main(argv)`` runs with ``--device cpu`` at a tiny size, runs
the plain versions, prints one JSON line and labels its times as CPU host
times; ``--device cuda`` without a card raises.  ``trace`` is a no-op for
None and writes a chrome trace for a directory; ``RateMeter`` gives what
the JAX package's meter gives on the same clock.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu.utils import profiling as jax_profiling
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.tools import (
    fold_geometry_probe, http_serve_probe, kernel_breakdown,
    kernel_sampling_stats, step_opt_probe, stream_latency,
    stream_server_probe, tts_phase_spans, tts_step_probe, wire_format_probe,
)
from wavernn_tpu_torch.utils import profiling
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
TINY_RAW = REPO / "tests" / "golden" / "tiny_wavernn_raw.msgpack"
TOOLS = {"kernel_breakdown": kernel_breakdown,
         "kernel_sampling_stats": kernel_sampling_stats,
         "fold_geometry_probe": fold_geometry_probe,
         "tts_step_probe": tts_step_probe,
         "tts_phase_spans": tts_phase_spans,
         "http_serve_probe": http_serve_probe,
         "stream_server_probe": stream_server_probe,
         "stream_latency": stream_latency,
         "step_opt_probe": step_opt_probe,
         "wire_format_probe": wire_format_probe}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tools' plain versions run many small eager
    ops, which threads would only contend for beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_hp(tmp_path) -> Path:
    """An hp file: the repository's hparams.py with the tiny RAW golden's
    vocoder dims."""
    f = tmp_path / "hp_tiny.py"
    f.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        "voc_rnn_dims = 32\nvoc_fc_dims = 32\nvoc_compute_dims = 16\n"
        "voc_res_out_dims = 16\nvoc_res_blocks = 2\nvoc_mode = 'RAW'\n")
    return f


def tiny_tts_hp(tmp_path) -> Path:
    """``tiny_hp`` with the tiny golden Tacotron's dims and its r = 2
    schedule."""
    dims = json.loads((REPO / "tests" / "golden"
                       / "tiny_tacotron_meta.json").read_text())["dims"]
    f = tiny_hp(tmp_path)
    with open(f, "a") as out:
        out.write("".join(f"tts_{k} = {dims[k]!r}\n" for k in (
            "embed_dims", "encoder_dims", "decoder_dims", "postnet_dims",
            "encoder_K", "lstm_dims", "postnet_K", "num_highways"))
            + "tts_schedule = [(2, 1e-4, 10_000, 8)]\n")
    return f


def cpu_argv(name, tmp_path):
    hp_file = str(tiny_hp(tmp_path))
    tiny = ["--voc_weights", str(TINY_RAW), "--hp_file", hp_file,
            "--target", "200", "--overlap", "28"]
    return {
        "kernel_breakdown": ["2", "4", "--reps", "1",
                             "--trace", str(tmp_path / "trace")],
        "kernel_sampling_stats": ["--rows", "4", "--steps", "64"],
        "fold_geometry_probe": ["--frames", "24", "--targets", "300,150",
                                "--overlap", "25", "--reps", "1", "--utts",
                                "1", "--voc_weights", str(TINY_RAW),
                                "--hp_file", str(tiny_hp(tmp_path))],
        "tts_step_probe": ["8", "1", "--passes", "1"],
        "tts_phase_spans": ["--L", "256"],
        "http_serve_probe": ["--concurrent", "2", "--tts_steps", "40",
                             "--tts_weights", str(REPO / "tests" / "golden"
                                                  / "tiny_tacotron.msgpack"),
                             "--voc_weights", str(TINY_RAW),
                             "--hp_file", str(tiny_tts_hp(tmp_path)),
                             "--target", "200", "--overlap", "28"],
        "stream_server_probe": ["--sessions", "2", "--frames", "24",
                                "--group", "8", "--width", "16"] + tiny,
        "stream_latency": ["--frames", "16", "--group", "16", "--reps",
                           "1"] + tiny,
        "step_opt_probe": ["--ab", "--widths", "1,4", "--T", "16",
                           "--passes", "1", "--reps", "1",
                           "--gates_widths", "4", "--voc_weights",
                           str(TINY_RAW), "--hp_file", hp_file,
                           "--mel", str(REPO / "tests" / "golden"
                                        / "tiny_wavernn_raw_mel.npy")],
        "wire_format_probe": ["--passes", "1", "--runs", "1", "--frames",
                              "16", "--mcd_frames", "24"] + tiny,
    }[name] + ["--device", "cpu"]


def timing_keys(obj):
    """Every key of a nested record that names a time or a rate."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if any(u in k for u in ("us_per", "ms_per", "khz")):
                yield k
            yield from timing_keys(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from timing_keys(v)


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_plain_versions_on_cpu(name, tmp_path, capsys):
    hp.reset()
    try:
        rec = TOOLS[name].main(cpu_argv(name, tmp_path))
    finally:
        hp.reset()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["device"] == "cpu"
    keys = list(timing_keys(rec))
    assert all(k.startswith("cpu_host_") for k in keys), keys
    if name == "kernel_breakdown":
        assert [v["name"] for v in rec["variants"]] == [
            n for n, _ in kernel_breakdown.VARIANTS]
        assert rec["variants"][0]["share_of_full"] == 1.0
        assert rec["floor"]["cpu_host_us_per_step"] > 0
        assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    elif name == "kernel_sampling_stats":
        assert rec["sampler"] == "plain" and rec["draws"] == 256
        assert np.isfinite([v for v in rec.values()
                            if isinstance(v, float)]).all()
    elif name == "fold_geometry_probe":
        r = rec["results"]
        assert [x["target"] for x in r] == [300, 150]
        assert [x["steps_per_launch"] for x in r] == [350, 200]
        assert r[1]["folds"] > r[0]["folds"] and r[0]["rows"] % 16 == 0
    elif name == "http_serve_probe":
        assert rec["health_ok"] and rec["stream_equals_oneshot"]
        assert rec["stream_repeats"] and rec["stream_samples"] == 39 * 275
        assert rec["r"] == 2     # the tiny golden's step in its schedule
        # chunks of 16 folds x 200 int16 samples, each under 64 KiB: the
        # first lands while the later ones still decode (~75% of the time)
        assert 0 < rec["cpu_host_stream_ttfb_ms"] < 0.95e3 * rec[
            "cpu_host_stream_s"]
        assert len(rec["cpu_host_latency_s"]) == 2 and rec["launches"] >= 2
    elif name == "stream_server_probe":
        assert rec["parity_max_abs_diff"] == 0 and rec["parity_launches"] > 0
        (s,) = rec["sweep"]
        assert s["concurrent_sessions"] == 2 and s["launches"] > 0
        assert s["audio_s_total"] == pytest.approx(2 * 23 * 275 / 22050)
    elif name == "stream_latency":
        assert rec["parity_max_abs_diff"] == 0
        assert rec["audio_s"] == pytest.approx(15 * 275 / 22050)
        assert rec["cpu_host_int16_g32_ramp4_ttfc_ms"] > 0
    elif name == "wire_format_probe":
        assert set(wire_format_probe.ARMS) == {
            k[len("mcd_"):] for k in rec if k.startswith("mcd_")}
        assert np.isfinite([rec[k] for k in rec if k.startswith("mcd_")]
                           ).all()
    elif name == "step_opt_probe":
        assert [w["rows"] for w in rec["widths"]] == [1, 4]
        assert rec["crossover_rows"] in (None, 1, 4)
        assert len(rec["ff_scales"]) == 3 and min(rec["ff_scales"]) > 0
        for w in rec["widths"]:
            for arm in ("int8_hh", "int8_ff"):
                assert w[arm]["cpu_host_median_us_per_step"] > 0
        # the int8_gates arm only at --gates_widths
        assert "int8_gates" not in rec["widths"][0]
        assert rec["widths"][1]["int8_gates"][
            "cpu_host_median_us_per_step"] > 0
    elif name == "tts_phase_spans":
        # the plan alone: the spans and the barrier loop need the card
        assert rec["grid"] == 132 and rec["smem_bytes"] == 135_664
        assert "phase_us" not in rec and "barrier_us" not in rec
    else:
        assert rec["kernel"]["steps_per_call"] == 4
        assert rec["plain"]["steps_per_call"] == 4


@pytest.mark.parametrize("L", [256, "limit+1"])
def test_tts_phase_spans_int8_lstm_prints_its_plan_on_cpu(L, capsys):
    """``--int8_lstm`` on the CPU: the int8_lstm variant's plan, in the
    shared placement or, past its 3,828 symbols
    (``cuda_tts.shared_text_limit``), the global one; nothing timed."""
    from wavernn_tpu_torch.ops.cuda_tts import shared_text_limit

    if L == "limit+1":
        L = shared_text_limit(256, 128, 512, 80, 2, 132, True) + 1
    rec = tts_phase_spans.main(["--L", str(L), "--int8_lstm", "--device",
                                "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["variant"] == "int8_lstm" and rec["grid"] == 132
    assert (L, rec["placement"], rec["smem_bytes"]) == (
        (256, "shared", 103_344) if L == 256 else (3_829, "global", 94_800))
    assert "phase_us" not in rec and "barrier_us" not in rec


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_on_cuda_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TOOLS[name].main(["--device", "cuda"])


def test_post_times_the_first_pcm_chunk_not_64_kib():
    """``http_serve_probe.post``'s TTFB is the time of the first chunk
    past the WAV header, though that chunk is far under 64 KiB and the
    next comes only 0.5 s later."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Chunked(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(200)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for i, n in enumerate((44, 1000, 1000)):
                if i == 2:
                    time.sleep(0.5)
                self.wfile.write(b"%x\r\n" % n + b"\1" * n + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, *args):
            pass

    httpd = HTTPServer(("127.0.0.1", 0), Chunked)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        body, first, total = http_serve_probe.post(
            httpd.server_address[1], "/stream", "hi", timeout=10)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert len(body) == 2044
    assert first < 0.4 and total >= 0.5


def test_trace_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(None):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "a" / "b"
    with profiling.trace(str(out)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_rate_meter_matches_jax(monkeypatch):
    clock = iter([100.0, 100.0, 102.0, 102.0, 104.0, 104.0])
    monkeypatch.setattr("time.time", lambda: next(clock))
    port, ref = profiling.RateMeter(), jax_profiling.RateMeter()
    for m in (port, ref):
        m.update()
        m.update(7)
    assert port.items == ref.items == 8
    assert port.rate == ref.rate == 4.0
    assert port.khz(22050) == ref.khz(22050) == pytest.approx(22050 / 4e3)
