"""Text cleaning pipelines for English TTS frontends.

The port's copy of ``pytorch_sound_tpu/data/eng_handler/cleaners.py``, same
logic (Tacotron-style).  `unidecode` is unavailable here, so ASCII transliteration is
done with a latin-accent folding table + NFKD fallback, which covers the same
practical surface for speech corpora (accented latin text).
"""

import re
import unicodedata

from pytorch_sound_tpu_torch.data.eng_handler.numbers import normalize_numbers

_whitespace_re = re.compile(r'\s+')

_abbreviations = [(re.compile(r'\b%s\.' % abbr, re.IGNORECASE), expansion) for abbr, expansion in [
    ('mrs', 'misess'),
    ('mr', 'mister'),
    ('dr', 'doctor'),
    ('st', 'saint'),
    ('co', 'company'),
    ('jr', 'junior'),
    ('maj', 'major'),
    ('gen', 'general'),
    ('drs', 'doctors'),
    ('rev', 'reverend'),
    ('lt', 'lieutenant'),
    ('hon', 'honorable'),
    ('sgt', 'sergeant'),
    ('capt', 'captain'),
    ('esq', 'esquire'),
    ('ltd', 'limited'),
    ('col', 'colonel'),
    ('ft', 'fort'),
]]

# Characters NFKD decomposition alone doesn't fold to ASCII.
_ASCII_FOLD = str.maketrans({
    'æ': 'ae', 'Æ': 'AE', 'œ': 'oe', 'Œ': 'OE', 'ø': 'o', 'Ø': 'O',
    'ß': 'ss', 'ð': 'd', 'Ð': 'D', 'þ': 'th', 'Þ': 'Th', 'đ': 'd', 'Đ': 'D',
    'ł': 'l', 'Ł': 'L', '’': "'", '‘': "'", '“': '"', '”': '"',
    '–': '-', '—': '-', '…': '...', ' ': ' ',
})


def convert_to_ascii(text: str) -> str:
    """Transliterate to ASCII (accent folding + NFKD decomposition)."""
    text = text.translate(_ASCII_FOLD)
    text = unicodedata.normalize('NFKD', text)
    return text.encode('ascii', 'ignore').decode('ascii')


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = regex.sub(replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(' ', text)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration + lowercase + whitespace collapse."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline: transliterate, lowercase, expand numbers and abbreviations."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text
