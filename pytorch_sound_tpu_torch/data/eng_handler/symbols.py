"""English text symbol inventory.

The port's copy of ``pytorch_sound_tpu/data/eng_handler/symbols.py`` (the
standard Tacotron character set): a pad symbol, `-`, punctuation, and ASCII
letters.  ARPAbet symbols get a leading `@` to disambiguate them from uppercase
letters; they are *not* part of the exported vocabulary (matching the reference,
which comments them out), but are still encodable through the curly-brace escape
in :mod:`pytorch_sound_tpu_torch.data.eng_handler`.
"""

from pytorch_sound_tpu_torch.data.eng_handler import cmudict

PAD = '_'
SPECIAL = '-'
PUNCTUATION = "!'(),.:;? "
LETTERS = 'ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz'

# ARPAbet set, '@'-prefixed for uniqueness against single letters.
arpabet = ['@' + s for s in cmudict.valid_symbols]

# Exported vocabulary (ARPAbet excluded, as in the reference).
symbols = [PAD] + list(SPECIAL) + list(PUNCTUATION) + list(LETTERS)
