"""The port's quality tools on the CPU: ``check_mel_parity``,
``kernel_quality`` (two training steps), ``tts_kernel_parity`` and
``tts_train_probe`` (``wavernn_tpu_torch/tools/``).

Each ``main(["--device", "cpu", ...])`` at a tiny size runs the plain
versions and prints one JSON line with the tool's keys, its numbers finite
and its times labelled CPU host times; ``--device cuda`` without a card
raises, for these four and ``train_golden``.  ``check_mel_parity``'s
signals equal the JAX tool's byte for byte (``tools/check_mel_parity.py``,
imported by path), and its host and torch pipelines pass the 0.1 dB gate.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.tools import (
    check_mel_parity, kernel_quality, non_finite, train_golden,
    tts_kernel_parity, tts_train_probe,
)
from tests.test_torch_kernel_quality import MEASURED, tiny_hp
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
TOOLS = {"check_mel_parity": (check_mel_parity, []),
         "kernel_quality": (kernel_quality, []),
         "tts_kernel_parity": (tts_kernel_parity, []),
         "tts_train_probe": (tts_train_probe, []),
         "train_golden": (train_golden, ["--which", "tiny", "--out",
                                         "unused"])}


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def finite(rec) -> bool:
    return not non_finite(rec)


def test_non_finite_names_the_paths():
    rec = {"a": 1.0, "ok": True, "s": "x", "b": {"c": float("nan"),
                                                  "d": {"e": float("inf")}}}
    assert non_finite(rec) == [".b.c", ".b.d.e"]
    assert non_finite({"a": 0, "b": {"c": -2.5}}) == []


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_cuda_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool, argv = TOOLS[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)


def test_synth_signals_equal_the_jax_tools():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_check_mel_parity", REPO / "tools" / "check_mel_parity.py")
    jax_cmp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cmp)
    got, want = check_mel_parity.synth_signals(), jax_cmp.synth_signals()
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_check_mel_parity_passes_its_gate(capsys):
    rec = check_mel_parity.main(["--device", "cpu"])
    assert last_json(capsys) == rec and finite(rec)
    assert rec["ok"] and rec["gate_db"] == 0.1
    assert set(rec["signals"]) == {"tone440", "chirp", "noise"}
    worst = max(s["numpy_vs_torch_mcd"] for s in rec["signals"].values())
    assert rec["worst_numpy_vs_torch_mcd"] == worst < 0.1


def test_check_mel_parity_fails_past_its_gate(monkeypatch, capsys):
    from wavernn_tpu_torch.dsp import metrics

    monkeypatch.setattr(metrics, "mcd", lambda a, b: 0.25)
    with pytest.raises(SystemExit, match="diverge"):
        check_mel_parity.main(["--device", "cpu"])
    rec = last_json(capsys)
    assert not rec["ok"] and rec["worst_numpy_vs_torch_mcd"] == 0.25


def test_kernel_quality_trains_then_measures(tmp_path, capsys):
    rec = kernel_quality.main([
        "--steps", "2", "--batch_size", "2", "--eval_frames", "8",
        "--seeds", "0", "--mode", "RAW", "--hp_file", str(tiny_hp(tmp_path)),
        "--device", "cpu"])
    assert last_json(capsys) == rec and finite(rec)
    for k in MEASURED + ["final_loss", "cpu_host_train_seconds"]:
        assert k in rec, k
    assert rec["train_steps"] == 2
    assert not any(k.startswith("mcd_") for k in rec)


def test_tts_kernel_parity_on_cpu(capsys):
    rec = tts_kernel_parity.main(["--train", "1", "--int8", "--steps", "8",
                                  "--passes", "1", "--device", "cpu"])
    assert last_json(capsys) == rec and finite(rec)
    assert rec["frames"] == rec["frames_plain"] == rec["frames_kernel"] == 8
    assert rec["frames_kernel_int8"] == 8
    # the kernel's plain version (bf16 weights) against the float32 decoder
    assert 0 < rec["mel_max_abs_diff"] < 2e-2
    assert 0 < rec["mel_max_abs_diff_int8"] < 2e-2
    for k in ("plain", "kernel", "kernel_int8"):
        assert rec[f"cpu_host_frames_per_s_{k}"] > 0
    assert rec["kernel_launches"] == rec["kernel_launches_int8"] == 0
    assert rec["train_steps"] == 1 and rec["final_train_loss"] > 0


def test_tts_train_probe_on_cpu(capsys):
    rec = tts_train_probe.main(["2", "6", "8", "--passes", "1", "--device",
                                "cpu"])
    assert last_json(capsys) == rec and finite(rec)
    assert (rec["B"], rec["L"], rec["T"], rec["r"], rec["K"]) == (2, 6, 8,
                                                                 2, 4)
    for piece in tts_train_probe.PIECES:
        assert rec[piece]["cpu_host_ms"] > 0 and "kernels" not in rec[piece]
    assert set(rec["shares"]) == {"optimizer", "backward", "dropout_zoneout",
                                  "decoder_residual"}
    ms = {p: rec[p]["cpu_host_ms"] for p in tts_train_probe.PIECES}
    assert rec["shares"]["backward"]["cpu_host_ms"] == (ms["loss_grad"]
                                                        - ms["forward_train"])
    assert rec["shares"]["dropout_zoneout"]["cpu_host_ms"] == (
        ms["forward_train"] - ms["forward_train_nodrop"])


def test_tts_train_probe_takes_its_calls_a_pass(capsys):
    rec = tts_train_probe.main(["2", "6", "8", "--passes", "1", "--calls",
                                "1", "--device", "cpu"])
    assert last_json(capsys) == rec and finite(rec) and rec["K"] == 1
    for piece in tts_train_probe.PIECES:
        assert rec[piece]["cpu_host_ms"] > 0


def test_train_forward_without_dropout_or_zoneout():
    """The probe's ``forward_train_nodrop``: train mode with both prenets'
    dropout at 0 and four None masks equals train mode given all-keep
    prenet masks and all-False zoneout masks (dropout 0: a kept value is
    scaled by 1), and differs from train mode with its drawn masks."""
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, draw_decoder_masks, from_jax_variables,
        init_variables,
    )

    cfg = TacotronConfig(embed_dims=16, num_chars=20, encoder_dims=8,
                         decoder_dims=16, postnet_dims=8, encoder_K=2,
                         lstm_dims=16, postnet_K=2, num_highways=1)
    model = from_jax_variables(init_variables(cfg, 0), cfg, "cpu").train()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(1, 20, (2, 5)))
    m = torch.from_numpy(rng.uniform(-4, 4, (2, 6, 80)).astype(np.float32))
    drawn = model(x, m, 2, True, generator=torch.Generator().manual_seed(1))
    for p in (model.encoder.pre_net, model.decoder.prenet):
        p.dropout = 0.0
    with torch.no_grad():
        off = model(x, m, 2, True, masks=(None,) * 4)
        pm1, pm2, z1, z2 = draw_decoder_masks(cfg, 3, 2, "cpu")
        given = model(x, m, 2, True, masks=(
            torch.ones_like(pm1), torch.ones_like(pm2),
            torch.zeros_like(z1), torch.zeros_like(z2)))
    for a, b, c in zip(off, given, drawn):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert a.shape == c.shape
    assert not torch.equal(off[0], drawn[0])
