"""The port stands alone: no module of ``wavernn_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax, msgpack or the JAX package,
since the machine with the card has none of them."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).parent.parent
PORT = REPO / "wavernn_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|msgpack|wavernn_tpu)"
    r"(?:[.\s,]|$)",
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
    ported = {str(p.relative_to(PORT)) for p in _sources()
              if PORT in p.parents}
    assert serving <= ported and training <= ported and parallel <= ported


def test_every_port_module_imports_with_jax_blocked():
    """A fresh interpreter in which importing any of them raises loads
    every module of the port."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import importlib, importlib.abc, sys\n"
        "NO = ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'wavernn_tpu')\n"
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
