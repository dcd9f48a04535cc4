"""The port's ``kernel_quality`` (``wavernn_tpu_torch/tools/
kernel_quality.py``) on the CPU, against the JAX tool
(``tools/kernel_quality.py``, imported by path).

Its corpus and its training batches equal the JAX tool's byte for byte:
both tools' ``main`` run with their models and train steps stubbed, the
batches recorded.  ``main --device cpu`` on the tiny RAW golden prints one
finite JSON line with the tool's keys, through the kernel's plain version
(no launch); ``tests/test_torch_quality_tools.py`` runs it with two
training steps.
"""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from wavernn_tpu_torch.tools import kernel_quality, train_golden
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
GOLDEN = REPO / "tests" / "golden"
MEASURED = (["det_signal_std"]
            + [f"det_absdiff_{v}" for v in kernel_quality.KERNEL_VARIANTS])
MCD = ([f"mcd_{v}_{s}" for v in kernel_quality.VARIANTS
        for s in ("mean", "spread")]
       + ["mcd_delta_bf16_minus_scan", "mcd_delta_int8_ff_minus_bf16",
          "mcd_delta_int8_gates_minus_bf16"])


class Drawn(Exception):
    """Stops a tool once its batches are recorded."""


def tiny_hp(tmp_path) -> Path:
    """hparams.py with the tiny RAW golden's vocoder and short folds."""
    f = tmp_path / "hp_tiny.py"
    f.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        "voc_rnn_dims = 32\nvoc_fc_dims = 32\nvoc_compute_dims = 16\n"
        "voc_res_out_dims = 16\nvoc_res_blocks = 2\nvoc_mode = 'RAW'\n"
        "voc_target = 200\nvoc_overlap = 28\n")
    return f


def recorder(drawn: list, n: int):
    def step(state, x, t, m, *rest):
        drawn.append(tuple(np.asarray(a) for a in (x, t, m)))
        if len(drawn) == n:
            raise Drawn
        return state, 0.0, None
    return step


def test_harmonic_signal_equals_the_jax_tools():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_kernel_quality", REPO / "tools" / "kernel_quality.py")
    jax_kq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_kq)
    for seconds in (1.0, 2.5):
        got = train_golden.harmonic_signal(22050, seconds)
        assert got.tobytes() == jax_kq.harmonic_signal(22050,
                                                       seconds).tobytes()


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_batch_draws_equal_the_jax_tools(mode, monkeypatch):
    """Both tools' ``main --steps 2 --batch_size 3 --mode mode``.  The JAX
    modules that bind ``WaveRNN`` by name are imported before it is
    stubbed, so that they keep the real one."""
    import wavernn_tpu.infer.eval  # noqa: F401
    import wavernn_tpu.models.wavernn as jax_wavernn
    import wavernn_tpu.ops.decode  # noqa: F401
    import wavernn_tpu.training.state as jax_state
    import wavernn_tpu.training.wavernn as jax_training
    import wavernn_tpu_torch.training.wavernn as port_training
    from wavernn_tpu.config import hp as jax_hp

    want, got = [], []
    monkeypatch.setattr(jax_wavernn, "WaveRNN", lambda cfg: SimpleNamespace(
        init=lambda *a: {"params": {}, "batch_stats": {}}))
    monkeypatch.setattr(jax_state, "new_train_state", lambda *a: None)
    monkeypatch.setattr(jax_training, "make_train_step",
                        lambda *a, **k: recorder(want, 2))
    monkeypatch.setattr(port_training, "make_train_step",
                        lambda *a, **k: recorder(got, 2))
    argv = ["--steps", "2", "--batch_size", "3", "--mode", mode]
    spec = importlib.util.spec_from_file_location(
        "jax_tool_kernel_quality", REPO / "tools" / "kernel_quality.py")
    jax_kq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_kq)
    monkeypatch.setattr(sys, "argv", ["kernel_quality.py"] + argv)
    jax_hp.reset()
    try:
        with pytest.raises(Drawn):
            jax_kq.main()
    finally:
        jax_hp.reset()
    with pytest.raises(Drawn):
        kernel_quality.main(argv + ["--device", "cpu"])
    assert len(got) == len(want) == 2
    for g_batch, w_batch in zip(got, want):
        for g, w in zip(g_batch, w_batch):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


def finite_record(rec: dict, keys) -> None:
    for k in keys:
        assert np.isfinite(rec[k]), k


def test_main_on_the_tiny_golden(tmp_path, capsys):
    rec = kernel_quality.main([
        "--weights", str(GOLDEN / "tiny_wavernn_raw.msgpack"), "--eval_mel",
        str(GOLDEN / "tiny_wavernn_raw_mel.npy"), "--eval_frames", "8",
        "--seeds", "1", "--mode", "RAW", "--hp_file", str(tiny_hp(tmp_path)),
        "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    finite_record(rec, MEASURED + MCD + ["cpu_host_measure_seconds"])
    assert rec["train_steps"] == 0 and "final_loss" not in rec
    assert rec["kernel_launches"] == {"launches": 0, "launches_int8_ff": 0,
                                      "launches_int8_gates": 0}
    # the plain versions are near the scan, but not equal to it
    for v in kernel_quality.KERNEL_VARIANTS:
        assert 0 < rec[f"det_absdiff_{v}"] < 0.1 * rec["det_signal_std"], v

