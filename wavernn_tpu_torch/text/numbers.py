"""Number verbalization for English text normalization.

Native replacement for the reference's inflect dependency
(ref: utils/text/numbers.py): cardinals with optional 'and', ordinals,
2-digit year grouping with 'oh', currency, and decimal expansion.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = ["", " thousand", " million", " billion", " trillion",
           " quadrillion", " quintillion", " sextillion", " septillion",
           " octillion", " nonillion", " decillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _three_digits(n: int, andword: str = "and") -> str:
    hundreds, rest = divmod(n, 100)
    if hundreds == 0:
        return _two_digits(rest)
    out = _ONES[hundreds] + " hundred"
    if rest:
        joiner = f" {andword} " if andword else " "
        out += joiner + _two_digits(rest)
    return out


def number_to_words(num, andword: str = "and", zero: str = "zero",
                    group: int = 0) -> str:
    """English words for an integer.

    ``group=2`` renders digit pairs left-to-right (year style: 1905 →
    'nineteen, oh five'), matching how the reference uses inflect.
    """
    s = str(num).strip()
    negative = s.startswith("-")
    if negative:
        s = s[1:]
    s = s.lstrip("+")

    if group == 2:
        if len(s) % 2 == 1:
            s = "0" + s
        parts = []
        for i in range(0, len(s), 2):
            pair = s[i: i + 2]
            v = int(pair)
            if v == 0:
                parts.append(f"{zero} {zero}")
            elif v < 10:
                parts.append(f"{zero} {_ONES[v]}" if pair[0] == "0" else _ONES[v])
            else:
                parts.append(_two_digits(v))
        words = ", ".join(parts)
        return ("minus " + words) if negative else words

    n = int(s)
    if n == 0:
        return zero
    if n >= 1000 ** len(_SCALES):
        # beyond named scales: read the digits individually (robust fallback;
        # such tokens are ids/serials, not quantities)
        words = " ".join(zero if d == "0" else _ONES[int(d)] for d in s)
        return ("minus " + words) if negative else words
    groups = []
    scale = 0
    while n > 0:
        n, chunk = divmod(n, 1000)
        if chunk:
            groups.append(_three_digits(chunk, andword) + _SCALES[scale])
        scale += 1
    words = ", ".join(reversed(groups))
    return ("minus " + words) if negative else words


def ordinal_to_words(num) -> str:
    """English ordinal words: 23 → 'twenty-third'."""
    words = number_to_words(num)
    tokens = words.replace("-", " - ").split()
    final = tokens[-1]
    if final in _ORDINAL_IRREGULAR:
        repl = _ORDINAL_IRREGULAR[final]
    elif final.endswith("ty"):
        repl = final[:-1] + "ieth"
    else:
        repl = final + "th"
    tokens[-1] = repl
    return " ".join(tokens).replace(" - ", "-")


# -- text normalization pass --------------------------------------------------
#
# One tokenizer sweep over the text: a single master pattern recognizes
# currency / decimal / ordinal / cardinal tokens (ordered most- to least-
# specific) and a handler table verbalizes each token completely in place.
# Observable behavior matches the reference's sequential substitution
# pipeline (ref: utils/text/numbers.py) and is pinned by
# tests/test_text.py::test_normalize_numbers_pipeline — including the
# quirks a TTS frontend must keep for checkpoint-compatible training text:
# year-style reading of 4-digit numbers in (1000, 3000), comma-grouped
# digits collapsing before verbalization, and currency amounts splitting
# into unit/subunit words.

_TOKEN_RE = re.compile(
    r"""
    \$(?P<dollars>[0-9.,]*[0-9])        # $1,000.50 — whole + cents
  | £(?P<pounds>[0-9,]*[0-9])           # £100 — integer amounts only
  | (?P<decimal>[0-9][0-9,]*\.[0-9]+)   # 3.14 — 'point' reading
  | (?P<ordinal>[0-9][0-9,]*[0-9]|[0-9])(?:st|nd|rd|th)  # 23rd, 1,021st
  | (?P<cardinal>[0-9][0-9,]*[0-9]|[0-9])
    """,
    re.VERBOSE,
)


def verbalize_integer(digits: str) -> str:
    """Cardinal reading of a digit run, with the conventional year-style
    grouping for 4-digit values in (1000, 3000): 1999 → 'nineteen
    ninety-nine', 2000 → 'two thousand', 2005 → 'two thousand five',
    1900 → 'nineteen hundred'."""
    num = int(digits.replace(",", ""))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(
            num, andword="", zero="oh", group=2
        ).replace(", ", " ")
    return number_to_words(num, andword="")


def _currency(amount: str, unit: str, subunit: str) -> str:
    parts = amount.replace(",", "").split(".")
    if len(parts) > 2:  # malformed ($1.2.3): read every field
        return (" point ".join(verbalize_integer(p) for p in parts if p)
                + f" {unit}s")
    whole = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    words = []
    if whole:
        words.append(f"{verbalize_integer(str(whole))} "
                     f"{unit if whole == 1 else unit + 's'}")
    if cents:
        words.append(f"{verbalize_integer(str(cents))} "
                     f"{subunit if cents == 1 else subunit + 's'}")
    return ", ".join(words) if words else f"zero {unit}s"


_HANDLERS = {
    "dollars": lambda tok: _currency(tok, "dollar", "cent"),
    # the reference reads £ amounts as integers with a fixed plural
    "pounds": lambda tok: f"{verbalize_integer(tok)} pounds",
    "decimal": lambda tok: " point ".join(
        verbalize_integer(p) for p in tok.replace(",", "").split(".")
    ),
    "ordinal": lambda tok: ordinal_to_words(int(tok.replace(",", ""))),
    "cardinal": verbalize_integer,
}


def _verbalize_token(m: re.Match) -> str:
    kind = m.lastgroup
    return _HANDLERS[kind](m.group(kind))


def normalize_numbers(text: str) -> str:
    return _TOKEN_RE.sub(_verbalize_token, text)
