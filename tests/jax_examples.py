"""Shared by the port's example tests (``tests/test_torch_examples_*.py``):
the JAX package's examples (``examples/*.py``, which are scripts, not a
package) imported by path, the JAX ``hp`` singleton cleared around a test
that runs one of their ``main``s, and their flax models' ``init`` under
``jax.jit``."""

import importlib.util
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).parent.parent


def jax_example(name: str):
    """``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def clean_hp():
    """Both packages' ``hp`` cleared before and after the test."""
    from wavernn_tpu.config import hp as jax_hp
    from wavernn_tpu_torch.config import hp

    jax_hp.reset()
    hp.reset()
    yield
    jax_hp.reset()
    hp.reset()


def argv(monkeypatch, script: str, *args) -> None:
    """Set ``sys.argv`` for a JAX example's ``main()``, which reads it."""
    monkeypatch.setattr(sys, "argv", [script, *map(str, args)])


class JittedInit:
    """A JAX example's flax model with ``init`` under ``jax.jit`` (its
    Python-scalar arguments static)."""

    def __init__(self, model):
        self.model = model

    def init(self, rngs, *args):
        arrays = [i for i, a in enumerate(args) if hasattr(a, "shape")]

        def init(rngs, *xs):
            full = list(args)
            for i, x in zip(arrays, xs):
                full[i] = x
            return self.model.init(rngs, *full)
        return jax.jit(init)(rngs, *(args[i] for i in arrays))

    def __getattr__(self, name):
        return getattr(self.model, name)
