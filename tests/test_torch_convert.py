"""The port's checkpoint converters (``wavernn_tpu_torch/tools/
convert_torch_checkpoint.py`` and ``export_torch_checkpoint.py``) against
the JAX package's tools, on the committed tiny goldens (the RAW WaveRNN
and the Tacotron of ``tests/golden/``).

Reference-layout state dicts come from the JAX tool's exporter.  The port's
layout functions must equal the JAX tool's leaf for leaf with dtype; the
port's converter must write the JAX tool's file byte for byte from the
same ``.pyt`` (the JAX tools run in one subprocess); the port's export must
equal the JAX tool's key for key, dtype and value; export then convert
must give the golden back leaf for leaf, apart from the width of ``step``
(the converter writes the int64 that ``np.asarray(int)`` gives, as the JAX
tool does).  The converted trees then drive the port: the vocoder's
deterministic int16 output equals the port's on the golden byte for byte
and JAX's within the copy-synthesis tests' tolerance (95% of samples
within 655 LSB), and the Tacotron mel equals the JAX decode's committed
pin within 1e-3, as ``tests/test_torch_tts_generator.py`` holds it."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.tools import convert_torch_checkpoint as convert
from wavernn_tpu_torch.tools import export_torch_checkpoint as export
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).parent.parent
GOLDEN = REPO / "tests" / "golden"
META = json.loads((GOLDEN / "tiny_tacotron_meta.json").read_text())
WEIGHTS = {"wavernn": GOLDEN / "tiny_wavernn_raw.msgpack",
           "tacotron": GOLDEN / "tiny_tacotron.msgpack"}
TINY_VOC = dict(voc_rnn_dims=32, voc_fc_dims=32, voc_compute_dims=16,
                voc_res_out_dims=16, voc_res_blocks=2, voc_mode="RAW")
SCHEDULE = [(2, 1e-4, 10_000, 8)]          # r = 2 at the golden's step
MODELS = ("wavernn", "tacotron")


def jax_tool(name: str):
    """A module of the repository's ``tools/`` loaded under its own name
    (no ``sys.path`` entry)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CONVERT = jax_tool("convert_torch_checkpoint")
JAX_EXPORT = jax_tool("export_torch_checkpoint")


def golden(model: str):
    blob = load_pytree(WEIGHTS[model])
    return blob["params"], blob["batch_stats"], int(blob["step"])


def reference_sd(model: str) -> dict:
    """The golden as a reference-layout state dict, by the JAX exporter."""
    params, stats, step = golden(model)
    if model == "wavernn":
        return JAX_EXPORT.export_wavernn(params, stats, step, (5, 5, 11))
    return JAX_EXPORT.export_tacotron(params, stats, step, META["r"], -3.4)


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def assert_same_tree(got, want, skip=()):
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        if k in skip:
            continue
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """An hp file with both tiny models' dims, each golden as a ``.pyt``,
    and the JAX tools' files: each ``.pyt`` converted and each golden
    exported, all in one subprocess."""
    d = tmp_path_factory.mktemp("convert")
    dims = META["dims"]
    tts = dict(tts_embed_dims=dims["embed_dims"],
               tts_encoder_dims=dims["encoder_dims"],
               tts_decoder_dims=dims["decoder_dims"],
               tts_postnet_dims=dims["postnet_dims"],
               tts_encoder_K=dims["encoder_K"],
               tts_lstm_dims=dims["lstm_dims"],
               tts_postnet_K=dims["postnet_K"],
               tts_num_highways=dims["num_highways"], tts_schedule=SCHEDULE)
    hp_file = d / "hp_tiny.py"
    hp_file.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        + "".join(f"{k} = {v!r}\n" for k, v in {**TINY_VOC, **tts}.items()))
    argvs = []
    for model in MODELS:
        torch.save({k: torch.from_numpy(np.array(v))
                    for k, v in reference_sd(model).items()},
                   d / f"{model}.pyt")
        argvs.append([str(REPO / "tools" / "convert_torch_checkpoint.py"),
                      model, str(d / f"{model}.pyt"),
                      str(d / f"{model}_jax.msgpack"), "--hp_file",
                      str(hp_file)])
        argvs.append([str(REPO / "tools" / "export_torch_checkpoint.py"),
                      model, str(WEIGHTS[model]), str(d / f"{model}_jax.pyt"),
                      "--hp_file", str(hp_file)])
    code = ("import runpy, sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from wavernn_tpu.config import hp\n"
            f"for argv in {argvs!r}:\n"
            "    hp.reset()\n"
            "    sys.argv = argv\n"
            "    runpy.run_path(argv[0], run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=d,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return d, hp_file


def port_main(tool, argv):
    hp.reset()
    try:
        return tool.main(argv)
    finally:
        hp.reset()


@pytest.mark.parametrize("model", MODELS)
def test_layout_functions_equal_jax(model):
    sd = reference_sd(model)
    if model == "wavernn":
        args = (sd, 2, (5, 5, 11))
        got, want = convert.convert_wavernn(*args), \
            JAX_CONVERT.convert_wavernn(*args)
    else:
        args = (sd, 8, 4, 2)
        got, want = convert.convert_tacotron(*args), \
            JAX_CONVERT.convert_tacotron(*args)
        assert got[3] == want[3] == META["r"]
    assert_same_tree(got[0], want[0])
    assert_same_tree(got[1], want[1])
    assert got[2] == want[2] == golden(model)[2]
    params, stats, step = golden(model)
    if model == "wavernn":
        args = (params, stats, step, (5, 5, 11))
        e_got, e_want = export.export_wavernn(*args), \
            JAX_EXPORT.export_wavernn(*args)
    else:
        args = (params, stats, step, 2, -3.4)
        e_got, e_want = export.export_tacotron(*args), \
            JAX_EXPORT.export_tacotron(*args)
    assert list(e_got) == list(e_want)
    for k in e_got:
        assert e_got[k].dtype == e_want[k].dtype, k
        np.testing.assert_array_equal(e_got[k], e_want[k], err_msg=k)


@pytest.mark.parametrize("model", MODELS)
def test_converter_file_byte_equal_to_jax_tool(work, model, tmp_path):
    d, hp_file = work
    out = tmp_path / "sub" / f"{model}.msgpack"
    port_main(convert, [model, str(d / f"{model}.pyt"), str(out),
                        "--hp_file", str(hp_file)])
    want = (d / f"{model}_jax.msgpack").read_bytes()
    assert out.read_bytes() == want
    assert load_pytree(out)["step"].dtype == np.int64


@pytest.mark.parametrize("model", MODELS)
def test_export_file_equals_jax_tool(work, model, tmp_path):
    d, hp_file = work
    out = tmp_path / "sub" / f"{model}.pyt"
    port_main(export, [model, str(WEIGHTS[model]), str(out), "--hp_file",
                       str(hp_file)])
    got = torch.load(out, map_location="cpu", weights_only=True)
    want = torch.load(d / f"{model}_jax.pyt", map_location="cpu",
                      weights_only=True)
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.dtype == want[k].dtype and t.is_contiguous(), k
        assert torch.equal(t, want[k]), k
    bn = [k for k in got if k.endswith("num_batches_tracked")]
    assert bn and all(int(got[k]) == 0 for k in bn)
    assert all(t.dtype == torch.float32 for k, t in got.items()
               if k not in bn and k not in ("step", "decoder.r"))
    if model == "tacotron":
        assert int(got["decoder.r"]) == META["r"]   # r_for_step(6000)


@pytest.mark.parametrize("model", MODELS)
def test_export_then_convert_is_the_identity(work, model, tmp_path):
    _, hp_file = work
    pyt, back = tmp_path / "m.pyt", tmp_path / "m.msgpack"
    port_main(export, [model, str(WEIGHTS[model]), str(pyt), "--hp_file",
                       str(hp_file)])
    port_main(convert, [model, str(pyt), str(back), "--hp_file",
                        str(hp_file)])
    got, want = load_pytree(back), load_pytree(WEIGHTS[model])
    assert_same_tree(got, want, skip={("step",)})
    assert got["step"].dtype == np.int64 and got["step"] == want["step"]


def test_converted_trees_drive_the_port(work, tmp_path):
    from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
    from wavernn_tpu.ops.decode import Generator as JaxGenerator
    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.models.tacotron import TacotronConfig
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.text import text_to_sequence

    d, hp_file = work
    trees = {}
    for model in MODELS:
        out = tmp_path / f"{model}.msgpack"
        port_main(convert, [model, str(d / f"{model}.pyt"), str(out),
                            "--hp_file", str(hp_file)])
        blob = load_pytree(out)
        trees[model] = {"params": blob["params"],
                        "batch_stats": blob["batch_stats"]}

    kw = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
              res_blocks=2, mode="RAW")
    serve = dict(deterministic=True, input_dtype="float16",
                 output_dtype="int16")
    mel = np.load(GOLDEN / "tiny_wavernn_raw_mel.npy")[:, :9]
    call = dict(batched=True, target=200, overlap=28, mu_law=True)
    gold = load_pytree(WEIGHTS["wavernn"])
    gold = {"params": gold["params"], "batch_stats": gold["batch_stats"]}
    got = Generator(WaveRNNConfig(**kw), trees["wavernn"], device="cpu",
                    **serve)(mel, **call)
    same = Generator(WaveRNNConfig(**kw), gold, device="cpu",
                     **serve)(mel, **call)
    want = JaxGenerator(JaxConfig(**kw), gold, backend="scan",
                        **serve)(mel, **call)
    assert got.dtype == want.dtype == np.int16
    assert got.shape == want.shape == (8 * 275,)
    np.testing.assert_array_equal(got, same)
    lsb = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert np.mean(lsb <= 655) >= 0.95, np.mean(lsb <= 655)

    seq = text_to_sequence(META["eval_text"], ["english_cleaners"])
    m, _, _ = TTSGenerator(TacotronConfig(**META["dims"]),
                           trees["tacotron"], "cpu", steps=400,
                           stop_patience=6)(seq, r=META["r"])
    pin = np.load(GOLDEN / "tiny_tacotron_mel.npy")
    assert m.shape == pin.shape
    np.testing.assert_allclose(m, pin, atol=1e-3)
