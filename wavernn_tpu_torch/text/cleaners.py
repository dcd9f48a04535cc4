"""Text cleaner pipelines (ref: utils/text/cleaners.py).

Cleaners run over input text at train and eval time; select by name through
``hp.tts_cleaner_names``:
  * english_cleaners — ASCII fold + lowercase + number & abbreviation expansion
  * transliteration_cleaners — ASCII fold + lowercase
  * basic_cleaners — lowercase + whitespace collapse only
"""

from __future__ import annotations

import re

from wavernn_tpu_torch.text.numbers import normalize_numbers
from wavernn_tpu_torch.text.translit import transliterate

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expansion)
    for abbr, expansion in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text: str) -> str:
    return transliterate(text)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration pipeline for non-English text."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline: ASCII, lowercase, numbers, abbreviations."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)
