"""English text <-> id sequence codec with ARPAbet curly-brace escapes.

The port's copy of ``pytorch_sound_tpu/data/eng_handler/__init__.py``, same
logic (Tacotron-style).  ``text_to_sequence("hi {HH AY1}", ['english_cleaners'])``
cleans plain-text spans and encodes ``{...}`` spans as '@'-prefixed ARPAbet.
"""

import re
from typing import List

from pytorch_sound_tpu_torch.data.eng_handler import cleaners
from pytorch_sound_tpu_torch.data.eng_handler.symbols import symbols

_SYM_ID = {s: i for i, s in enumerate(symbols)}
_ID_SYM = dict(enumerate(symbols))
# ids for the pad/eos markers are never emitted by the encoder
_MARKERS = ('_', '~')

# splits "abc {HH AY1} def" -> ['abc ', 'HH AY1', ' def']; even indices are
# plain text, odd indices are ARPAbet spans
_CURLY_SPLIT = re.compile(r'\{(.+?)\}')


def _encode(syms) -> List[int]:
    return [_SYM_ID[s] for s in syms if s in _SYM_ID and s not in _MARKERS]


def _clean(span: str, cleaner_names: List[str]) -> str:
    for name in cleaner_names:
        fn = getattr(cleaners, name, None)
        if fn is None:
            raise ValueError('Unknown cleaner: %s' % name)
        span = fn(span)
    return span


def text_to_sequence(text: str, cleaner_names: List[str]) -> List[int]:
    """Convert text to a list of symbol ids. Plain spans run through the
    named cleaners character-by-character; ``{...}`` spans are encoded as
    '@'-prefixed ARPAbet tokens.

    As in the JAX package, which departs here from the Tacotron codec:
    there, a newline *before* a ``{...}`` span accidentally disables ARPAbet
    parsing for the rest of the string (its scan regex can't cross lines);
    here the span is still honored.
    """
    out: List[int] = []
    for i, span in enumerate(_CURLY_SPLIT.split(text)):
        if i % 2:
            out.extend(_encode('@' + tok for tok in span.split()))
        else:
            out.extend(_encode(_clean(span, cleaner_names)))
    return out


def sequence_to_text(sequence: List[int]) -> str:
    """Inverse of :func:`text_to_sequence`; ARPAbet ids re-wrap in braces."""
    pieces = []
    for idx in sequence:
        sym = _ID_SYM.get(idx)
        if sym is None:
            continue
        pieces.append('{%s}' % sym[1:] if sym.startswith('@') else sym)
    return ''.join(pieces).replace('}{', ' ')
