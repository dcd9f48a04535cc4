"""CMU pronouncing dictionary support.

Capability parity with the reference (ref: utils/text/cmudict.py): the
ARPAbet inventory feeding the model's ``@``-prefixed symbol table, and a
loader for cmudict-formatted files so pronunciations can be injected via
``{ARPAbet}`` escapes in input text.

The parser here is regex-driven: each entry line is matched in one shot —
head word (with optional ``(n)`` alternate marker) and phone string — and
the phones are validated against the ARPAbet inventory.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, IO, List, Optional, Union

# The fixed ARPAbet phone inventory (stress-marked vowels + consonants).
# Order matters: wavernn_tpu_torch.text.symbols derives embedding rows from it.
valid_symbols = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1",
    "AH2", "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0",
    "AY1", "AY2", "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0",
    "ER1", "ER2", "EY", "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0",
    "IH1", "IH2", "IY", "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2", "P", "R", "S", "SH",
    "T", "TH", "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2", "V", "W",
    "Y", "Z", "ZH",
]

_ARPABET = frozenset(valid_symbols)

# Entry lines start with an uppercase word (or leading apostrophe), carry an
# optional "(n)" alternate-pronunciation marker, and separate word from
# phones with a double space.  Comment lines (";;;") fail the match.
_ENTRY = re.compile(r"^(?P<word>['A-Z][^ (]*)(?:\(\d+\))?  (?P<phones>[^\n]+)")


class CMUDict:
    """In-memory word → ARPAbet pronunciation table.

    ``source`` is a path or an open text file in cmudict format.  With
    ``keep_ambiguous=False``, words with multiple pronunciations are dropped
    entirely (useful when a single deterministic expansion is wanted).
    """

    def __init__(self, source: Union[str, Path, IO[str]],
                 keep_ambiguous: bool = True):
        if isinstance(source, (str, Path)):
            with open(source, encoding="latin-1") as f:
                table = _read_entries(f)
        else:
            table = _read_entries(source)
        if not keep_ambiguous:
            table = {w: prons for w, prons in table.items() if len(prons) == 1}
        self._entries = table

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        """All ARPAbet pronunciations for ``word`` (case-insensitive), or
        None if absent."""
        return self._entries.get(word.upper())


def _read_entries(lines: IO[str]) -> Dict[str, List[str]]:
    table: Dict[str, List[str]] = {}
    for raw in lines:
        m = _ENTRY.match(raw)
        if not m:
            continue
        phones = m.group("phones").split("  ")[0].strip().split(" ")
        if all(p in _ARPABET for p in phones):
            table.setdefault(m.group("word"), []).append(" ".join(phones))
    return table
