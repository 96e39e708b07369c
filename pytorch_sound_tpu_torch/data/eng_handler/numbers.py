"""English number normalization for TTS text cleaning.

The port's copy of ``pytorch_sound_tpu/data/eng_handler/numbers.py``, same
logic (Tacotron-style, which builds on `inflect`).  `inflect` is not available in this
environment, so a self-contained cardinal/ordinal spell-out engine is provided
instead; it covers the same surface: comma removal, pounds/dollars, decimals,
ordinals, year-style grouping for 1000 < n < 3000, and plain cardinals.
"""

import re

_ONES = ['zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven', 'eight',
         'nine', 'ten', 'eleven', 'twelve', 'thirteen', 'fourteen', 'fifteen',
         'sixteen', 'seventeen', 'eighteen', 'nineteen']
_TENS = ['', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy',
         'eighty', 'ninety']
_SCALES = [(10 ** 12, 'trillion'), (10 ** 9, 'billion'), (10 ** 6, 'million'),
           (10 ** 3, 'thousand'), (100, 'hundred')]

_ORDINAL_IRREGULAR = {
    'one': 'first', 'two': 'second', 'three': 'third', 'five': 'fifth',
    'eight': 'eighth', 'nine': 'ninth', 'twelve': 'twelfth',
}


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    word = _TENS[tens]
    return word + ('-' + _ONES[ones] if ones else '')


def number_to_words(n: int, andword: str = 'and', zero: str = 'zero') -> str:
    """Spell out a non-negative integer. ``andword`` joins hundreds with the
    remainder (``'' `` disables it, matching inflect's andword='')."""
    if n == 0:
        return zero
    parts = []
    for scale, name in _SCALES:
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(number_to_words(q, andword=andword) + ' ' + name)
    if n > 0:
        tail = _under_100(n)
        if parts and andword:
            tail = andword + ' ' + tail
        parts.append(tail)
    return ' '.join(parts)


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n, andword='')
    head, _, last = words.rpartition(' ')
    hyph_head, _, hyph_last = last.rpartition('-')
    if hyph_last in _ORDINAL_IRREGULAR:
        ordinal_last = _ORDINAL_IRREGULAR[hyph_last]
    elif hyph_last.endswith('y'):
        ordinal_last = hyph_last[:-1] + 'ieth'
    else:
        ordinal_last = hyph_last + 'th'
    last = (hyph_head + '-' if hyph_head else '') + ordinal_last
    return (head + ' ' if head else '') + last


def _two_digit_groups(n: int, zero_word: str = 'oh') -> str:
    """Year-style reading: 1984 -> 'nineteen eighty-four', 1907 -> 'nineteen oh seven'."""
    hi, lo = divmod(n, 100)
    if lo == 0:
        return number_to_words(hi, andword='') + ' hundred'
    lo_word = (zero_word + ' ' + _ONES[lo]) if lo < 10 else _under_100(lo)
    return number_to_words(hi, andword='') + ' ' + lo_word


_comma_number_re = re.compile(r'([0-9][0-9\,]+[0-9])')
_decimal_number_re = re.compile(r'([0-9]+\.[0-9]+)')
_pounds_re = re.compile(r'£([0-9\,]*[0-9]+)')
_dollars_re = re.compile(r'\$([0-9\.\,]*[0-9]+)')
_ordinal_re = re.compile(r'[0-9]+(st|nd|rd|th)')
_number_re = re.compile(r'[0-9]+')


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(',', '')


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace('.', ' point ')


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split('.')
    if len(parts) > 2:
        return match + ' dollars'  # unexpected format: leave digits as-is
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        return '%s %s, %s %s' % (dollars, 'dollar' if dollars == 1 else 'dollars',
                                 cents, 'cent' if cents == 1 else 'cents')
    if dollars:
        return '%s %s' % (dollars, 'dollar' if dollars == 1 else 'dollars')
    if cents:
        return '%s %s' % (cents, 'cent' if cents == 1 else 'cents')
    return 'zero dollars'


def _expand_ordinal(m: re.Match) -> str:
    return number_to_ordinal_words(int(m.group(0)[:-2]))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return 'two thousand'
        if 2000 < num < 2010:
            return 'two thousand ' + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100, andword='') + ' hundred'
        return _two_digit_groups(num)
    return number_to_words(num, andword='')


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(_remove_commas, text)
    text = _pounds_re.sub(r'\1 pounds', text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(_expand_decimal_point, text)
    text = _ordinal_re.sub(_expand_ordinal, text)
    text = _number_re.sub(_expand_number, text)
    return text
