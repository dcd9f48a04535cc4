"""The port stands alone: no module of ``wavernn_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax, msgpack or the JAX package,
since the machine with the card has none of them; nor the repository's
root CLIs and tools (``quick_start``, ``gen_wavernn``, ``serve``, ``bench``,
the converters, ...), which import them, nor puts the root ``tools/`` on
``sys.path``.  The port keeps its own copies of those."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).parent.parent
PORT = REPO / "wavernn_tpu_torch"
NO_IMPORT = ("jax", "jaxlib", "flax", "optax", "msgpack", "wavernn_tpu",
             # the repository's root modules
             "convert_torch_checkpoint", "export_torch_checkpoint",
             "quick_start", "gen_wavernn", "gen_tacotron", "train_wavernn",
             "train_tacotron", "serve", "bench")
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(" + "|".join(NO_IMPORT) + r")(?:[.\s,]|$)"
    r"|sys\.path\.(?:insert|append|extend)\(.*\btools\b",
    re.M)


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_no_forbidden_import_in_the_source():
    hits = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
            for p in _sources() for m in FORBIDDEN.finditer(p.read_text())]
    assert not hits, hits
    assert len(_sources()) > 20
    serving = {"dsp/audio.py", "dsp/metrics.py", "infer/eval.py",
               "infer/stream_server.py", "infer/http_server.py", "serve.py",
               "dsp/torch_audio.py", "utils/display.py",
               "tools/http_serve_probe.py", "tools/stream_server_probe.py",
               "tools/stream_latency.py", "tools/wire_format_probe.py"}
    training = {"utils/files.py", "paths.py", "text/recipes.py",
                "data/preprocess.py", "data/loader.py", "data/dataset.py",
                "training/state.py", "training/wavernn.py", "pruning.py",
                "preprocess.py", "train_wavernn.py", "utils/checkpoints.py"}
    parallel = {"parallel/__init__.py", "parallel/mesh.py",
                "parallel/distributed.py", "tools/multihost_smoke.py",
                "tools/mesh_kernel_probe.py"}
    weights = {"models/deepmind_wavernn.py", "examples/__init__.py",
               "examples/nb1_sine_wave.py",
               "tools/convert_torch_checkpoint.py",
               "tools/export_torch_checkpoint.py", "quick_start.py"}
    quality = {f"tools/{t}.py" for t in (
        "check_mel_parity", "kernel_quality", "tts_kernel_parity",
        "tts_train_probe", "train_golden")}
    examples = {f"examples/{e}.py" for e in (
        "nb2_fit_single_sample", "nb3_fit_long_sample",
        "nb4_alternative_model", "pruning_example", "serving_demo",
        "e2e_tts")}
    ported = {str(p.relative_to(PORT)) for p in _sources()
              if PORT in p.parents}
    assert serving <= ported and training <= ported and parallel <= ported
    assert weights <= ported and quality <= ported and examples <= ported


@pytest.mark.parametrize("line,hit", [
    ("import jax.numpy as jnp", True),
    ("from wavernn_tpu.dsp import audio", True),
    ("    from quick_start import main", True),
    ("import gen_wavernn", True),
    ("from convert_torch_checkpoint import convert_wavernn", True),
    ("import serve, bench", True),
    ("sys.path.insert(0, str(REPO / 'tools'))", True),
    ("sys.path.append(str(Path(__file__).parent / 'tools'))", True),
    ("from wavernn_tpu_torch.quick_start import main", False),
    ("from wavernn_tpu_torch import gen_tacotron, gen_wavernn", False),
    ("from wavernn_tpu_torch.tools import convert_torch_checkpoint", False),
    ("import wavernn_tpu_torch.serve", False),
    ("sys.path.insert(0, str(REPO))", False),
])
def test_forbidden_pattern(line, hit):
    assert bool(FORBIDDEN.search(line)) == hit


def test_every_port_module_imports_with_jax_blocked():
    """A fresh interpreter in which importing any of them raises loads
    every module of the port."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import importlib, importlib.abc, sys\n"
        f"NO = {NO_IMPORT!r}\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in NO]:\n"
        "    del sys.modules[k]\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in NO:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
