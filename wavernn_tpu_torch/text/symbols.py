"""Model input symbol inventory (ref: utils/text/symbols.py).

Pad + punctuation + ASCII letters + '@'-prefixed ARPAbet phonemes.  Symbol IDs
are the Tacotron embedding indices; order therefore matters for checkpoint
compatibility.
"""

from wavernn_tpu_torch.text import cmudict

_pad = "_"
_punctuation = "!'(),.:;? "
_special = "-"
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

# Prepend "@" to ARPAbet symbols to ensure uniqueness (some equal uppercase letters).
_arpabet = ["@" + s for s in cmudict.valid_symbols]

symbols = [_pad] + list(_special) + list(_punctuation) + list(_letters) + _arpabet
