"""The port's ``kernel_quality.measure`` (``wavernn_tpu_torch/tools/
kernel_quality.py``) against the JAX tool's deterministic numbers, each
decoder run by the JAX package's ``Generator`` on the same inputs (the
Pallas kernel in interpret mode).
"""

import functools
from pathlib import Path

import numpy as np

from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu.ops import decode as jax_decode
from wavernn_tpu.ops import pallas_decode
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.tools import kernel_quality, load_variables
from tests.torch_cpu import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"


def test_measure_matches_the_jax_generators(monkeypatch):
    """:func:`kernel_quality.measure` on the tiny RAW golden (8 frames,
    target 100 / overlap 14) against the JAX tool's deterministic numbers
    computed by the JAX package's ``Generator``: the scan, and the Pallas
    kernel (interpret mode) with bf16 feed-forward matrices and with
    int8_gates.  Tolerance: each number within 1e-6 of JAX's.  Both pick
    the same RAW label at every step here, so only float rounding is left
    (below 1e-8); one label one step off moves a mean by ~2e-6, and
    swapping bf16 for int8_gates moves each by ~1e-5.
    """
    monkeypatch.setattr(pallas_decode, "decode", functools.partial(
        pallas_decode.decode, interpret=True))
    dims = dict(rnn_dims=32, fc_dims=32, bits=9, pad=2,
                upsample_factors=(5, 5, 11), feat_dims=80, compute_dims=16,
                res_out_dims=16, res_blocks=2, hop_length=275,
                sample_rate=22050, mode="RAW")
    v = load_variables(GOLDEN / "tiny_wavernn_raw.msgpack")
    mel = np.load(GOLDEN / "tiny_wavernn_raw_mel.npy")[:, :8]
    geom = dict(batched=True, target=100, overlap=14, mu_law=True)
    jax_kw = {"scan": dict(backend="scan"),
              "bf16": dict(backend="pallas", int8_ff=False),
              "int8_gates": dict(backend="pallas", int8_gates=True)}
    det = {name: jax_decode.Generator(JaxConfig(**dims), v, fold_bucket=16,
                                      deterministic=True, **kw)(mel, **geom)
           for name, kw in jax_kw.items()}
    got = kernel_quality.measure(WaveRNNConfig(**dims), v, mel, "cpu", 0,
                                 100, 14, True)
    want = {"det_signal_std": np.std(det["scan"])}
    for name in ("bf16", "int8_gates"):
        want[f"det_absdiff_{name}"] = np.mean(np.abs(det[name]
                                                     - det["scan"]))
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-6, (k, got[k], w)
    assert 0 < want["det_absdiff_bf16"] and 0 < want["det_absdiff_int8_gates"]
