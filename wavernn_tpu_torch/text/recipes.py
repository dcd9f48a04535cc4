"""Dataset metadata recipes: dataset directory → ``{utterance_id: transcript}``.

A copy of ``wavernn_tpu/text/recipes.py`` (ref: utils/text/recipes.py).
A recipe owns the quirks of one corpus layout; preprocessing only sees the
resulting dict.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

from wavernn_tpu_torch.utils.files import get_files


def ljspeech(path: Union[str, Path]) -> Dict[str, str]:
    """LJSpeech layout: a single pipe-delimited ``metadata.csv`` whose rows
    are ``id|raw text|normalized text``.  The final (normalized) field is
    kept verbatim — including its line terminator, which the cleaner
    pipeline later collapses — matching the reference's behavior exactly."""
    candidates = get_files(path, extension=".csv")
    if len(candidates) != 1:
        raise FileNotFoundError(
            f"expected exactly one metadata .csv under {path}, "
            f"found {len(candidates)}"
        )
    with open(candidates[0], encoding="utf-8") as f:
        return {fields[0]: fields[-1] for fields in
                (line.split("|") for line in f)}
