"""The ``gen_int8`` path of the port: ``Generator(int8_gates=True)``
against the JAX package's Pallas Generator, the flag's effect on the
other int8 options, and the entry points that read ``hp.gen_int8`` as the
JAX package does (``make_generator``, ``gen_wavernn --int8 / --no_int8``,
``gen_tacotron --int8``, the serve CLI's pipeline built from an hp file
that sets it).  The decode kernel's ``int8_gates`` variant itself is in
``tests/test_torch_int8_gates.py``.

Tolerance: the slice through ``Generator`` as ``tests/test_torch_int8_ff.py``
holds it, 95% of int16 samples within 655 LSB (the int8 sums are exact in
both packages; float32 sums in other orders can move an operand across a
quantization boundary).  The entry points run the kernel's plain version
on the CPU at the committed tiny goldens' size; each records the variant
of every decode it makes."""

import functools

import numpy as np
import pytest
import torch

from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu.ops import decode as jax_decode
from wavernn_tpu.ops import pallas_decode
from wavernn_tpu_torch import gen_tacotron, gen_wavernn, serve
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.infer.wavernn import make_generator
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops import cuda_decode
from wavernn_tpu_torch.ops import decode as port_decode
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.test_torch_cli import WEIGHTS, cli_args, tts_args  # noqa: F401
from tests.test_torch_decode import REPO
from tests.test_torch_int8_ff import OVERLAP, SERVE, TARGET, mel, small
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pallas_decode, "decode", functools.partial(
        pallas_decode.decode, interpret=True))


def test_generator_int8_gates_matches_jax_pallas(interpret_pallas):
    """The slice: JAX's Pallas Generator with int8_gates (interpret mode)
    against the port's, deterministic, one mel."""
    kw, v = small("MOL")
    m = mel(4)
    jgen = jax_decode.Generator(JaxConfig(**kw), v, backend="pallas",
                                int8_gates=True, **SERVE)
    want = jgen(m, batched=True, target=TARGET, overlap=OVERLAP,
                mu_law=False)
    gen = Generator(WaveRNNConfig(**kw), v, device="cpu", int8_gates=True,
                    **SERVE)
    got = gen(m, batched=True, target=TARGET, overlap=OVERLAP, mu_law=False)
    assert jgen.int8_hh is False and jgen.int8_ff is False
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    lsb = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert np.mean(lsb <= 655) >= 0.95, np.mean(lsb <= 655)


def test_int8_gates_turns_int8_hh_and_int8_ff_off():
    """As in the JAX package: the flag forces int8_hh and int8_ff off (no
    calibration runs), ``update_variables`` repacks, and the scan backend
    ignores it."""
    kw, v = small("MOL")
    cfg = WaveRNNConfig(**kw)
    gen = Generator(cfg, v, device="cpu", int8_gates=True, int8_hh=True,
                    int8_ff=True, **SERVE)
    assert (gen.int8_gates, gen.int8_hh, gen.int8_ff) == (True, False, False)
    assert cuda_decode.variant(gen.packed) == "int8_gates"
    gen(mel(3), batched=True, target=TARGET, overlap=OVERLAP, mu_law=False)
    assert gen.ff_scales is None and gen.packed_ff is None
    _, v2 = small("MOL", seed=1)
    before = gen.packed["w_hh1"]
    gen.update_variables(v2)
    assert cuda_decode.variant(gen.packed) == "int8_gates"
    assert not torch.equal(gen.packed["w_hh1"], before)
    scan = Generator(cfg, v, device="cpu", backend="scan", int8_gates=True,
                     **SERVE)
    plain = Generator(cfg, v, device="cpu", backend="scan", **SERVE)
    assert scan.packed is None
    np.testing.assert_array_equal(
        scan(mel(3), batched=True, target=TARGET, overlap=OVERLAP,
             mu_law=False),
        plain(mel(3), batched=True, target=TARGET, overlap=OVERLAP,
              mu_law=False))


# -- the gen_int8 path ------------------------------------------------------

@pytest.fixture()
def variants(monkeypatch):
    """The variant of every decode the port makes (its pack's)."""
    seen = []
    decode = cuda_decode.decode

    def spy(packed, *args, **kwargs):
        seen.append(cuda_decode.variant(packed))
        return decode(packed, *args, **kwargs)

    monkeypatch.setattr(cuda_decode, "decode", spy)
    return seen


def hp_with_gen_int8(args):
    """``args``' hp file with ``gen_int8 = True`` appended."""
    hp_file = args[args.index("--hp_file") + 1]
    with open(hp_file, "a") as f:
        f.write("gen_int8 = True\n")
    return hp_file


def test_make_generator_reads_gen_int8(cli_args):  # noqa: F811
    hp.configure(hp_with_gen_int8(cli_args))
    blob = load_pytree(WEIGHTS)
    v = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    cfg = WaveRNNConfig(rnn_dims=32, fc_dims=32, compute_dims=16,
                        res_out_dims=16, res_blocks=2, mode="RAW")
    gen = make_generator(cfg, v, "cpu")
    assert gen.int8_gates and cuda_decode.variant(gen.packed) == "int8_gates"
    assert not make_generator(cfg, v, "cpu", int8_gates=False).int8_gates


@pytest.mark.parametrize("how,gates", [
    ("--int8", True), ("hp file", True), ("hp file --no_int8", False)])
def test_gen_wavernn_decodes_with_gen_int8(cli_args, variants,  # noqa: F811
                                           how, gates, monkeypatch):
    # without int8_gates the int8_ff policy calibrates: keep it short
    monkeypatch.setattr(port_decode, "FF_CAL_STEPS", 64)
    argv = cli_args + ["--device", "cpu"]
    if how.startswith("hp file"):
        hp_with_gen_int8(cli_args)
    argv += [a for a in how.split() if a.startswith("--")]
    out = gen_wavernn.main(argv)
    assert out.exists() and len(variants) == 1
    assert (variants[0] == "int8_gates") == gates, variants


def test_gen_tacotron_int8_decodes_with_int8_gates(tts_args,  # noqa: F811
                                                   variants):
    (out,) = gen_tacotron.main(tts_args + [
        "--device", "cpu", "--int8", "wavernn", "--voc_weights",
        str(WEIGHTS), "--target", "200", "--overlap", "28"])
    assert out.exists() and variants == ["int8_gates"]


def test_serve_pipeline_from_gen_int8_file(tts_args, variants):  # noqa: F811
    """The serve CLI's pipeline, built from an hp file that sets
    ``gen_int8 = True``, vocodes through int8_gates."""
    hp_file = hp_with_gen_int8(tts_args)
    service, httpd = serve.setup(serve.parse_args([
        "--hp_file", hp_file, "--voc_weights", str(WEIGHTS),
        "--tts_weights", tts_args[tts_args.index("--tts_weights") + 1],
        "--port", "0", "--no_warmup", "--device", "cpu",
        "--slot_seconds", "2"]))
    try:
        voc = service.server.pipeline.voc
        assert voc.int8_gates and not voc.int8_hh
        wav = voc(np.load(REPO / "tests" / "golden" /
                          "tiny_wavernn_raw_mel.npy")[:, :8],
                  batched=True, target=200, overlap=28, mu_law=True)
        assert wav.dtype == np.int16 and len(wav) == 7 * 275
    finally:
        httpd.server_close()
        service.close()
    assert variants == ["int8_gates"]
