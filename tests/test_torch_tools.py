"""The port's kernel-measurement tools (``wavernn_tpu_torch/tools/``) and its
profiling hooks (``wavernn_tpu_torch/utils/profiling.py``) on the CPU.

Each tool's ``main(argv)`` runs with ``--device cpu`` at a tiny size, runs
the plain versions, prints one JSON line and labels its times as CPU host
times; ``--device cuda`` without a card raises.  ``trace`` is a no-op for
None and writes a chrome trace for a directory; ``RateMeter`` gives what
the JAX package's meter gives on the same clock.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu.utils import profiling as jax_profiling
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.tools import (
    fold_geometry_probe, kernel_breakdown, kernel_sampling_stats,
    tts_phase_spans, tts_step_probe,
)
from wavernn_tpu_torch.utils import profiling
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
TINY_RAW = REPO / "tests" / "golden" / "tiny_wavernn_raw.msgpack"
TOOLS = {"kernel_breakdown": kernel_breakdown,
         "kernel_sampling_stats": kernel_sampling_stats,
         "fold_geometry_probe": fold_geometry_probe,
         "tts_step_probe": tts_step_probe,
         "tts_phase_spans": tts_phase_spans}


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


def cpu_argv(name, tmp_path):
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
    elif name == "tts_phase_spans":
        # the plan alone: the spans and the barrier loop need the card
        assert rec["grid"] == 132 and rec["smem_bytes"] == 137_456
        assert "phase_us" not in rec and "barrier_us" not in rec
    else:
        assert rec["kernel"]["steps_per_call"] == 4
        assert rec["plain"]["steps_per_call"] == 4


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_on_cuda_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TOOLS[name].main(["--device", "cuda"])


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
