"""CMU pronouncing dictionary wrapper.

The port's copy of ``pytorch_sound_tpu/data/eng_handler/cmudict.py``, same
logic (Tacotron-style). Parses the standard CMUdict text format
(http://www.speech.cs.cmu.edu/cgi-bin/cmudict) into word -> [pronunciations].
"""

import re
from typing import IO, List, Optional, Union

# The 84-symbol ARPAbet inventory used by CMUdict (vowels carry 0/1/2 stress marks).
_VOWELS = ['AA', 'AE', 'AH', 'AO', 'AW', 'AY', 'EH', 'ER', 'EY',
           'IH', 'IY', 'OW', 'OY', 'UH', 'UW']
_CONSONANTS = ['B', 'CH', 'D', 'DH', 'F', 'G', 'HH', 'JH', 'K', 'L', 'M', 'N',
               'NG', 'P', 'R', 'S', 'SH', 'T', 'TH', 'V', 'W', 'Y', 'Z', 'ZH']

valid_symbols: List[str] = sorted(
    [v + s for v in _VOWELS for s in ('', '0', '1', '2')] + _CONSONANTS
)

_valid_symbol_set = frozenset(valid_symbols)

_ALT_MARK_RE = re.compile(r'\([0-9]+\)')


class CMUDict:
    """Thin lookup wrapper over a CMUdict file (or open file object)."""

    def __init__(self, file_or_path: Union[str, IO], keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding='latin-1') as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        """Return the list of ARPAbet pronunciations for ``word`` (or None)."""
        return self._entries.get(word.upper())


def _parse_cmudict(file: IO) -> dict:
    entries: dict = {}
    for line in file:
        if not line:
            continue
        head = line[0]
        if not ('A' <= head <= 'Z' or head == "'"):
            continue  # skip comments / punctuation entries
        parts = line.split('  ')
        if len(parts) < 2:
            continue
        word = _ALT_MARK_RE.sub('', parts[0])
        pron = _validated_pronunciation(parts[1])
        if pron is None:
            continue
        entries.setdefault(word, []).append(pron)
    return entries


def _validated_pronunciation(s: str) -> Optional[str]:
    parts = s.strip().split(' ')
    if all(p in _valid_symbol_set for p in parts):
        return ' '.join(parts)
    return None
