"""Filesystem helpers (a copy of ``wavernn_tpu/utils/files.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import List, Union


def get_files(path: Union[str, Path], extension: str = ".wav") -> List[Path]:
    """Recursively list files under ``path`` with the given extension,
    sorted for deterministic ordering across machines."""
    if isinstance(path, str):
        path = Path(path).expanduser().resolve()
    return sorted(path.rglob(f"*{extension}"))
