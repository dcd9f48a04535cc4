"""The port's text frontend (a copy of ``wavernn_tpu/text``) against the
JAX package's: the same symbol table, the same ids for the same text
(numbers, abbreviations, ``{ARPAbet}`` spans, non-ASCII), the same text
back.  Symbol ids are embedding rows, a checkpoint contract: equality is
exact."""

import pytest

from wavernn_tpu import text as jax_text
from wavernn_tpu.text import cleaners as jax_cleaners
from wavernn_tpu.text.symbols import symbols as jax_symbols
from wavernn_tpu_torch import text
from wavernn_tpu_torch.text import cleaners
from wavernn_tpu_torch.text.symbols import symbols
from tests.torch_cpu import one_torch_thread  # noqa: F401

TEXTS = [
    "I have 3 cats and 1,024 dogs.",
    "In 1999 it cost $1.50, in 2005 £100; 3.14 of 21st-century 2nd tries.",
    "Dr. Smith met Mrs. Jones and Mr. Brown on St. James ave. at 10 a.m.",
    "Turn left on {HH AW1 S} Street.",
    "{W ER1 L D}{HH AH0 L OW1} and then some {AA1 B S ER0 D} text",
    "Café crème, naïve Zoë — Ångström über straße: ½ “quoted”.",
    "Plain lower-case text, with punctuation! Does it (really) work? Yes: it; does.",
    "",
    "   multiple   spaces\tand\nnewlines   ",
]
CLEANERS = ["english_cleaners", "basic_cleaners", "transliteration_cleaners"]


def test_symbols_identical():
    assert symbols == jax_symbols
    assert len(symbols) == 148


@pytest.mark.parametrize("cleaner", CLEANERS)
@pytest.mark.parametrize("s", TEXTS, ids=range(len(TEXTS)))
def test_text_to_sequence_matches_jax(s, cleaner):
    got = text.text_to_sequence(s, [cleaner])
    assert got == jax_text.text_to_sequence(s, [cleaner])
    assert text.sequence_to_text(got) == jax_text.sequence_to_text(got)
    assert getattr(cleaners, cleaner)(s) == getattr(jax_cleaners, cleaner)(s)


def test_unknown_cleaner_raises_as_jax():
    with pytest.raises(ValueError, match="Unknown cleaner"):
        text.text_to_sequence("x", ["no_such_cleaner"])
    with pytest.raises(ValueError, match="Unknown cleaner"):
        jax_text.text_to_sequence("x", ["no_such_cleaner"])
