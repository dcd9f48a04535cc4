"""Runtime-loadable hyperparameter system (a copy of
``wavernn_tpu/config.py``, which is pure Python: the port carries its own so
that it never imports the JAX package).

Capability parity with the reference's ``hp.configure(path)`` singleton
(ref: utils/__init__.py:40-104): any ``.py`` file can serve as a config, its
module-level attributes are copied onto a process-wide singleton, double
configuration is an error, and every CLI accepts ``--hp_file``.

Beyond parity, this version adds:
  * ``hp.configure(path, **overrides)`` keyword overrides (CLI flags can
    patch single values without a new file),
  * ``hp.snapshot()`` returning a plain dict (for checkpoint metadata),
  * ``hp.reset()`` for test isolation,
  * derived-value validation (upsample factors must factorize hop_length).
"""

from __future__ import annotations

import re
from importlib.util import module_from_spec, spec_from_file_location
from pathlib import Path
from typing import Any, Dict, Union

_DUNDER_RE = re.compile(r"^__.+__$")


def _import_from_file(name: str, path: Path):
    """Load a python module object from an arbitrary filesystem path."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f'"{path}" doesn\'t exist!')
    spec = spec_from_file_location(name, path)
    if spec is None:
        raise ValueError(f'could not load module from "{path}"')
    module = module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _HParams:
    """Hyperparameter pseudo-module singleton.

    Attribute access before :meth:`configure` raises ``AttributeError`` so
    misconfigured scripts fail fast, matching the reference contract.
    """

    def __init__(self) -> None:
        object.__setattr__(self, "_store", {})
        object.__setattr__(self, "_configured", False)

    # -- core protocol -----------------------------------------------------

    def __getattr__(self, item: str) -> Any:
        store = object.__getattribute__(self, "_store")
        if item in store:
            return store[item]
        if not object.__getattribute__(self, "_configured"):
            raise AttributeError(
                "HParams not configured yet. Call hp.configure(path) first."
            )
        raise AttributeError(f"Unknown hyperparameter: {item!r}")

    def __setattr__(self, key: str, value: Any) -> None:
        object.__getattribute__(self, "_store")[key] = value

    def __contains__(self, item: str) -> bool:
        return item in object.__getattribute__(self, "_store")

    # -- public API ---------------------------------------------------------

    def is_configured(self) -> bool:
        return object.__getattribute__(self, "_configured")

    def get(self, name: str, default: Any = None) -> Any:
        """Attribute access with a default (hp raises on missing otherwise)."""
        store = object.__getattribute__(self, "_store")
        return store.get(name, default)

    def configure(self, path: Union[str, Path], **overrides: Any) -> "_HParams":
        """Copy attributes from the python module at ``path`` onto this
        singleton, then apply keyword ``overrides``.  Raises if already
        configured (matching the reference) or on attribute collisions.
        """
        if self.is_configured():
            raise RuntimeError("Cannot reconfigure hparams! (use hp.reset() in tests)")

        path = Path(path).expanduser()
        if not path.exists():
            raise FileNotFoundError(f"Could not find hparams file {path}")
        if path.suffix != ".py":
            raise ValueError("`path` must be a python file")

        module = _import_from_file("wavernn_tpu_hparams", path)
        store = object.__getattribute__(self, "_store")
        for name, value in module.__dict__.items():
            if _DUNDER_RE.match(name) or name.startswith("_"):
                continue
            if callable(value) and getattr(value, "__module__", "") != module.__name__:
                continue  # imported helpers, not config values
            if name in store:
                raise AttributeError(
                    f"config file cannot contain attribute {name!r}: it collides "
                    "with an already-set hyperparameter"
                )
            store[name] = value

        for name, value in overrides.items():
            store[name] = value

        object.__setattr__(self, "_configured", True)
        self._validate()
        return self

    def configure_from_dict(self, values: Dict[str, Any]) -> "_HParams":
        """Configure directly from a dict (used by tests and library callers)."""
        if self.is_configured():
            raise RuntimeError("Cannot reconfigure hparams! (use hp.reset() in tests)")
        store = object.__getattribute__(self, "_store")
        store.update(values)
        object.__setattr__(self, "_configured", True)
        self._validate()
        return self

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict copy of every hyperparameter (checkpoint metadata)."""
        return dict(object.__getattribute__(self, "_store"))

    def reset(self) -> None:
        """Clear all state. Test-only escape hatch."""
        object.__getattribute__(self, "_store").clear()
        object.__setattr__(self, "_configured", False)

    # -- validation ----------------------------------------------------------

    def _validate(self) -> None:
        store = object.__getattribute__(self, "_store")
        factors = store.get("voc_upsample_factors")
        hop = store.get("hop_length")
        if factors is not None and hop is not None:
            prod = 1
            for f in factors:
                prod *= f
            if prod != hop:
                raise ValueError(
                    f"voc_upsample_factors {factors} must factorize "
                    f"hop_length={hop} (product is {prod})"
                )
        seq_len = store.get("voc_seq_len")
        if seq_len is not None and hop is not None and seq_len % hop != 0:
            raise ValueError(f"voc_seq_len={seq_len} must be a multiple of hop_length={hop}")


hp = _HParams()


def default_hparams_path() -> Path:
    """Path of the repo-root default config shipped with the framework."""
    return Path(__file__).parent.parent / "hparams.py"
