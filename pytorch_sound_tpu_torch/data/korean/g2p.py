"""Korean grapheme-to-phoneme conversion: the port's copy of
``pytorch_sound_tpu/data/korean/g2p.py`` (KoG2P's engine and rule format).

* Hangul syllables are decomposed arithmetically per the Unicode standard
  (syllable = 0xAC00 + onset*588 + nucleus*28 + coda) and romanized with the
  phone inventory of :mod:`pytorch_sound_tpu_torch.data.korean` (PHONEMES).
* Phonological rules are regex rewrite pairs loaded from a rulebook file
  (tab-separated ``pattern<TAB>replacement`` lines, ``#`` comments) and applied
  until a fixpoint. The default is the full KoG2P rulebook in
  ``assets/rulebook.txt`` at the repository root; ``assets/korean_rules.txt``
  holds a smaller core-phonology book (coda neutralization, liaison,
  nasalization, tensification, aspiration, palatalization, liquid
  assimilation), the fallback where the full one is absent.
"""

import os
import re
from typing import List, Tuple

_ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..', '..', 'assets')
# the full KoG2P rulebook (~200 rules, lexical exceptions included);
# korean_rules.txt is the smaller core-phonology book, kept as a fallback and
# a minimal example of the rule format
DEFAULT_RULEBOOK_PATH = os.path.join(_ASSETS_DIR, 'rulebook.txt')
if not os.path.exists(DEFAULT_RULEBOOK_PATH):   # pragma: no cover
    DEFAULT_RULEBOOK_PATH = os.path.join(_ASSETS_DIR, 'korean_rules.txt')

# Romanization tables (Korean Spontaneous Speech corpus conventions).
# 'oh' is the placeholder for the silent onset ㅇ, resolved to '' / 'ng' below.
ONSETS = ['k0', 'kk', 'nn', 't0', 'tt', 'rr', 'mm', 'p0', 'pp',
          's0', 'ss', 'oh', 'c0', 'cc', 'ch', 'kh', 'th', 'ph', 'h0']
NUCLEI = ['aa', 'qq', 'ya', 'yq', 'vv', 'ee', 'yv', 'ye', 'oo', 'wa',
          'wq', 'wo', 'yo', 'uu', 'wv', 'we', 'wi', 'yu', 'xx', 'xi', 'ii']
CODAS = ['', 'kf', 'kk', 'ks', 'nf', 'nc', 'nh', 'tf',
         'll', 'lk', 'lm', 'lb', 'ls', 'lt', 'lp', 'lh',
         'mf', 'pf', 'ps', 's0', 'ss', 'oh', 'c0', 'ch',
         'kh', 'th', 'ph', 'h0']

_HANGUL_BASE = 0xAC00
_HANGUL_END = 0xD7A3


def is_hangul_syllable(ch: str) -> bool:
    return _HANGUL_BASE <= ord(ch) <= _HANGUL_END


def decompose_syllable(ch: str) -> Tuple[int, int, int]:
    """Return (onset, nucleus, coda) indices of a precomposed Hangul syllable."""
    df = ord(ch) - _HANGUL_BASE
    return df // 588, (df % 588) // 28, df % 28


def graph2phone(graphs: str) -> str:
    """Romanize Hangul text into hyphen-delimited syllables of 2-letter phones.

    Spaces become '#'. The silent-onset placeholder 'oh' is dropped in onset
    position and rewritten to 'ng' in coda position.
    """
    out = []
    for ch in graphs:
        if ch == ' ':
            out.append('#')
        elif is_hangul_syllable(ch):
            ons, nuc, cod = decompose_syllable(ch)
            syl = '-' + ONSETS[ons] + NUCLEI[nuc] + CODAS[cod]
            out.append(syl)
        # non-hangul, non-space characters are dropped (same as KoG2P)
    phones = ''.join(out)

    # onset ㅇ is silent
    phones = re.sub('^oh', '', phones)
    phones = re.sub('-(oh)', '-', phones)
    phones = re.sub('^-', '', phones)
    # coda ㅇ is the velar nasal
    phones = re.sub('oh-', 'ng-', phones)
    phones = re.sub('oh(#|$)', r'ng\1', phones)
    # tidy delimiters around '#'
    phones = re.sub(r'#-', '#', phones)
    phones = re.sub(r'#+$', '', phones)
    return phones


def add_phone_boundary(phones: str) -> str:
    """Insert a comma after every 2-letter phone; keep '-' and '#' markers."""
    out = []
    i = 0
    n = len(phones)
    while i < n:
        c = phones[i]
        if c in '-#':
            out.append(c)
            i += 1
            continue
        if c == ' ':
            i += 1
            continue
        out.append(phones[i:i + 2] + ',')
        i += 2
    return ''.join(out)


def read_rules(rule_book: str) -> Tuple[List[str], List[str]]:
    """Load rewrite rules: one ``pattern<TAB>replacement`` per line, '#'-comment lines skipped."""
    rule_in: List[str] = []
    rule_out: List[str] = []
    with open(rule_book, 'r', encoding='utf-8') as r:
        for line in r:
            line = line.rstrip('\n')
            if not line or line.startswith('#'):
                continue
            cols = line.split('\t')
            if len(cols) < 2:
                continue
            rule_in.append(cols[0])
            rule_out.append(cols[1])
    return rule_in, rule_out


def apply_rules(phones: str, rule_in: List[str], rule_out: List[str]) -> str:
    for pattern, replacement in zip(rule_in, rule_out):
        phones = re.sub(pattern, replacement, phones)
    return phones


def graph2prono(graphs: str, rule_in: List[str], rule_out: List[str]) -> str:
    """Romanize then rewrite with rules until the phone string stops changing."""
    romanized = add_phone_boundary(graph2phone(graphs))
    prono = apply_rules(romanized, rule_in, rule_out)

    prono = prono.replace(',', ' ').rstrip()
    prono = prono.replace('#', '-')
    prono = re.sub('-+', '-', prono)

    prev = prono
    while True:
        new = apply_rules(prev.replace(' ', ',') + ',', rule_in, rule_out)
        new = new.replace(',', ' ').rstrip()
        if prev.replace('-', '') == new.replace('-', ''):
            return new.replace('-', '')
        prev = new


class KoG2P:
    """Rule-based Korean g2p; pass ``rulebook_path`` to use a custom rulebook
    (e.g. the full upstream KoG2P rules) instead of the bundled core rules."""

    def __init__(self, rulebook_path: str = None):
        path = rulebook_path or DEFAULT_RULEBOOK_PATH
        self.rule_in, self.rule_out = read_rules(path)

    def g2p(self, text: str) -> str:
        return graph2prono(text, self.rule_in, self.rule_out)


# ---------------------------------------------------------------------------
# The classic KoG2P script surface (camelCase names), over this engine.
# ---------------------------------------------------------------------------

readRules = read_rules
addPhoneBoundary = add_phone_boundary


def writefile(body, fname):
    """Write an iterable of lines to ``fname`` (classic KoG2P utility)."""
    with open(fname, 'w') as out:
        for line in body:
            out.write('{}\n'.format(line))


def isHangul(charint: int) -> bool:
    """True when the codepoint is a precomposed Hangul syllable."""
    return _HANGUL_BASE <= charint <= _HANGUL_END


def checkCharType(var_list) -> List[int]:
    """Per-codepoint type tags: 1 = whitespace, 0 = Hangul, -1 = other."""
    return [1 if v == 32 else (0 if isHangul(v) else -1) for v in var_list]


def phone2prono(phones: str, rule_in: List[str], rule_out: List[str],
                space_chr: str = '#') -> str:
    """One rewrite pass of the rulebook over a phone string."""
    return apply_rules(phones, rule_in, rule_out)


def addSpace(phones: str) -> str:
    """Space-separate consecutive 2-letter phones."""
    pairs = [phones[i:i + 2] for i in range(0, len(phones) - 1, 2)]
    return ' '.join(pairs)


if __name__ == '__main__':
    import sys
    print(KoG2P().g2p(sys.argv[1]))
