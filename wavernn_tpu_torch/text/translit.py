"""ASCII transliteration — native replacement for the unidecode dependency.

Folds accented Latin characters, common typography (quotes, dashes,
ellipsis), Greek letters, and ligatures to plain ASCII; unknown non-ASCII
code points are dropped, matching unidecode's behavior of best-effort ASCII
output.  Covers the character classes appearing in LJSpeech-style corpora.
"""

from __future__ import annotations

import unicodedata

_EXPLICIT = {
    # typography
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"',
    "–": "-", "—": "-", "―": "-", "−": "-",
    "…": "...", " ": " ", "­": "",
    "«": '"', "»": '"',
    # ligatures & special letters without NFKD decompositions
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ß": "ss", "ẞ": "SS",
    "ø": "o", "Ø": "O",
    "đ": "d", "Đ": "D",
    "ł": "l", "Ł": "L",
    "þ": "th", "Þ": "Th", "ð": "d", "Ð": "D",
    "ı": "i",
    # currency/symbols commonly spelled out later by cleaners
    "€": "EUR", "¢": " cents", "©": "(c)", "®": "(r)",
    "°": " degrees ", "×": "x", "÷": "/",
    # greek (names appear in technical text)
    "α": "a", "β": "b", "γ": "g", "δ": "d",
    "ε": "e", "μ": "u", "π": "pi",
}


def transliterate(text: str) -> str:
    """Best-effort conversion of unicode text to plain ASCII."""
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _EXPLICIT:
            out.append(_EXPLICIT[ch])
            continue
        # strip combining marks: é → e, ñ → n, ü → u, ...
        decomposed = unicodedata.normalize("NFKD", ch)
        ascii_part = "".join(c for c in decomposed if ord(c) < 128
                             and unicodedata.category(c) != "Mn")
        out.append(ascii_part)  # may be empty → dropped
    return "".join(out)
