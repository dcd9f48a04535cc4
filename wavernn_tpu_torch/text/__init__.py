"""Text frontend: string ↔ symbol-ID sequence.

A copy of ``wavernn_tpu/text`` (pure Python), so that the port never
imports the JAX package; ``tests/test_torch_text.py`` holds the two equal.

Capability parity with the reference frontend (ref: utils/text/__init__.py),
re-structured around a split-based tokenizer: input text is partitioned into
alternating plain-text / ``{ARPAbet}`` segments in one pass, plain segments
run through the named cleaner pipelines, and phoneme segments map straight to
``@``-prefixed symbols.  Symbol IDs are a checkpoint-compatibility contract
(embedding rows), pinned by tests/test_text.py.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Sequence

from wavernn_tpu_torch.text import cleaners
from wavernn_tpu_torch.text.symbols import symbols

# Symbols never emitted into sequences: padding and EOS markers.
_SILENT = frozenset({"_", "~"})

_SYMBOL_IDS = {s: i for i, s in enumerate(symbols)}

# Splitting on this pattern yields [plain, phonemes, plain, phonemes, ...]:
# odd indices are the captured interiors of {...} spans.
_BRACED_SPAN = re.compile(r"\{(.+?)\}")


def _encode(syms: Iterable[str]) -> List[int]:
    return [
        _SYMBOL_IDS[s] for s in syms if s in _SYMBOL_IDS and s not in _SILENT
    ]


def _apply_cleaners(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        fn = getattr(cleaners, name, None)
        if fn is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = fn(text)
    return text


def text_to_sequence(text: str, cleaner_names: Sequence[str]) -> List[int]:
    """Convert a text string to a sequence of symbol IDs.

    Curly-brace spans hold space-separated ARPAbet phonemes ("Turn left on
    {HH AW1 S} Street."); everything else is passed through the named
    cleaner pipelines.  Unknown symbols are silently dropped.
    """
    ids: List[int] = []
    for i, segment in enumerate(_BRACED_SPAN.split(text)):
        if i % 2:  # interior of a {...} span
            ids += _encode("@" + phone for phone in segment.split())
        elif segment:
            ids += _encode(_apply_cleaners(segment, cleaner_names))
    return ids


def sequence_to_text(sequence: Sequence[int]) -> str:
    """Best-effort inverse of :func:`text_to_sequence` (for debugging /
    display).  Phoneme runs come back wrapped in curly braces, with adjacent
    spans merged into one."""
    rendered = []
    for symbol_id in sequence:
        if not 0 <= symbol_id < len(symbols):
            continue
        s = symbols[symbol_id]
        rendered.append("{%s}" % s[1:] if s.startswith("@") and len(s) > 1
                        else s)
    return "".join(rendered).replace("}{", " ")
