"""Measurement tools of the PyTorch port (ports of ``tools/`` of the JAX
package): the kernel-measurement tools ``kernel_breakdown``,
``kernel_sampling_stats``, ``fold_geometry_probe``, ``tts_step_probe`` and
``tts_phase_spans``, the serving probes ``http_serve_probe``,
``stream_server_probe``, ``stream_latency`` and ``wire_format_probe``, and
the parallel probes ``mesh_kernel_probe`` and ``multihost_smoke``, the
checkpoint converters ``convert_torch_checkpoint`` and
``export_torch_checkpoint`` (host only: reference ``.pyt`` <-> msgpack),
and the quality and golden tools ``check_mel_parity``, ``kernel_quality``,
``tts_kernel_parity``, ``tts_train_probe`` and ``train_golden``.

Each runs as ``python -m wavernn_tpu_torch.tools.<name>``; the probes run
on the card by default: ``--device cuda`` raises where CUDA is absent, and
``--device cpu`` runs the kernels' plain versions at the size the caller
gives, with every time labelled as a CPU host time.
"""

from __future__ import annotations

import contextlib
import math
import subprocess
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
GOLDEN = REPO / "bench_assets" / "wavernn_mol_golden.msgpack"
HPARAMS = REPO / "hparams.py"


def device_of(name: str) -> torch.device:
    """The torch device a tool runs on; never chosen silently."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for, but CUDA is not "
                           "available (use --device cpu to run the plain "
                           "versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def card(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def metric(name: str, dev: torch.device) -> str:
    """A timing key: the card's metric name on CUDA, a host-time name on the
    CPU, so that no CPU number sits under a device metric's name."""
    return name if dev.type == "cuda" else f"cpu_host_{name}"


def non_finite(rec, path: str = "") -> list:
    """The key paths of the numbers in a tool's JSON record (nested dicts)
    that are not finite; an empty list when all are."""
    if isinstance(rec, dict):
        return [p for k, v in rec.items()
                for p in non_finite(v, f"{path}.{k}")]
    if isinstance(rec, (int, float)) and not math.isfinite(rec):
        return [path]
    return []


def load_variables(path) -> dict:
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    blob = load_pytree(path)
    return {"params": blob["params"], "batch_stats": blob["batch_stats"]}


def voc_config(hp_file=None):
    """The vocoder config of ``hp_file`` (configured into ``hp``), or the
    default config (the golden's) when there is none."""
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig

    if hp_file is None:
        return WaveRNNConfig()
    from wavernn_tpu_torch.config import hp

    hp.configure(hp_file)
    return WaveRNNConfig.from_hp(hp)


def sync_of(dev: torch.device):
    """A function that waits for ``dev``'s queued work (a no-op on the
    CPU)."""
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


@contextlib.contextmanager
def hparams(path=None, **overrides):
    """``hp`` configured from ``path`` (the repository's ``hparams.py`` by
    default) and ``overrides`` inside the block, and cleared after it."""
    from wavernn_tpu_torch.config import hp

    hp.reset()
    hp.configure(HPARAMS if path is None else path, **overrides)
    try:
        yield hp
    finally:
        hp.reset()
