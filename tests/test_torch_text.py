"""The port's text frontends, settings and CLI parser against the JAX
package's copies they were taken from: symbol tables and constants equal,
the cleaners, number normalisation and codecs equal on sentences that reach
every rule, and ``fire_like`` turning the same argv into the same call."""

import dataclasses
import importlib

import numpy as np
import pytest

from pytorch_sound_tpu import settings as jax_settings
from pytorch_sound_tpu.data import eng_handler as jax_eng
from pytorch_sound_tpu.data import korean as jax_korean
from pytorch_sound_tpu.data.eng_handler import cleaners as jax_cleaners
from pytorch_sound_tpu.data.eng_handler import cmudict as jax_cmudict
from pytorch_sound_tpu.data.eng_handler import numbers as jax_numbers
from pytorch_sound_tpu.utils import cli as jax_cli
from pytorch_sound_tpu.utils import text as jax_text
from pytorch_sound_tpu_torch import settings
from pytorch_sound_tpu_torch.data import eng_handler, korean
from pytorch_sound_tpu_torch.data.eng_handler import cleaners, cmudict, numbers
from pytorch_sound_tpu_torch.utils import cli, text

# the packages' ``symbols`` attribute is the exported list, not the module
symbols = importlib.import_module('pytorch_sound_tpu_torch.data.eng_handler.symbols')
jax_symbols = importlib.import_module('pytorch_sound_tpu.data.eng_handler.symbols')

SENTENCES = [
    'Dr. Who owes $1,500!',
    'Mr. and Mrs. Smith paid £3.50 on the 21st of May, 1999.',
    'Capt. Lt. Sgt. Col. Gen. Maj. Rev. Hon. St. Co. Jr. Ltd. Esq. Ft. Drs.',
    'It cost $0.01, $1.00, $2.5, $12.345 and $1,000,000.',
    '1st 2nd 3rd 4th 11th 12th 13th 22nd 101st 1000th',
    'In 1066, 1900, 2000, 2005, 2010 and 3000 there were 12,345,678 people.',
    'The value is 3.14159 or -7, and 0.5%.',
    'Café naïve façade Æsir Œuvre straße Ðorđe łódź “quoted” ‘single’ – — …',
    'Hello {HH AH0 L OW1} world {W ER1 L D}, again.',
    'line one\nline two {T UW1}\tend',
    '  many    spaces   and   TABS\t\there  ',
    '¡Señor! ¿Qué? 日本語 ok',
    '',
]


def test_symbol_tables_and_settings_equal_jax():
    assert symbols.symbols == jax_symbols.symbols
    assert symbols.arpabet == jax_symbols.arpabet
    assert cmudict.valid_symbols == jax_cmudict.valid_symbols
    assert korean.PHONEMES == jax_korean.PHONEMES
    assert korean.GRAPHEMES == jax_korean.GRAPHEMES and korean.VOC_SIZE == jax_korean.VOC_SIZE
    names = [n for n in dir(jax_settings) if n.isupper()]
    assert names == [n for n in dir(settings) if n.isupper()]
    for name in names:
        ours, theirs = getattr(settings, name), getattr(jax_settings, name)
        if dataclasses.is_dataclass(ours):      # each package's own AudioConfig
            ours, theirs = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert ours == theirs, name
    assert (settings.DEFAULT_AUDIO_CONFIG.hop_stride, settings.DEFAULT_AUDIO_CONFIG.spec_size) \
        == (jax_settings.DEFAULT_AUDIO_CONFIG.hop_stride,
            jax_settings.DEFAULT_AUDIO_CONFIG.spec_size)


@pytest.mark.parametrize('sentence', SENTENCES)
def test_cleaners_and_codecs_equal_jax(sentence):
    for name in ('basic_cleaners', 'transliteration_cleaners', 'english_cleaners',
                 'convert_to_ascii', 'expand_abbreviations', 'collapse_whitespace'):
        assert getattr(cleaners, name)(sentence) == getattr(jax_cleaners, name)(sentence), name
    assert numbers.normalize_numbers(sentence) == jax_numbers.normalize_numbers(sentence)
    seq = eng_handler.text_to_sequence(sentence, ['english_cleaners'])
    assert seq == jax_eng.text_to_sequence(sentence, ['english_cleaners'])
    assert eng_handler.sequence_to_text(seq) == jax_eng.sequence_to_text(seq)
    got, ref = text.eng_t2i(sentence), jax_text.eng_t2i(sentence)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert text.eng_i2t(list(got[:-1])) == jax_text.eng_i2t(list(ref[:-1]))
    assert text.eng_c2i(sentence) == jax_text.eng_c2i(sentence)
    assert text.eng_i2c(text.eng_c2i(sentence)) == jax_text.eng_i2c(jax_text.eng_c2i(sentence))


def test_normalize_numbers_cases_equal_jax():
    for value in ['12', '1,234', '5,234', '3.14', '2nd', '21st', '2000', '2005', '£5',
                  '100', '$1', '$0.99', '$3.', '1,000,000,000,000', '0', '19th', '1500']:
        assert numbers.normalize_numbers(value) == jax_numbers.normalize_numbers(value), value
    with pytest.raises(ValueError):
        eng_handler.text_to_sequence('x', ['no_such_cleaner'])


def test_cmudict_parses_as_jax(tmp_path):
    path = tmp_path / 'dict.txt'
    path.write_text(';;; comment\nHELLO  HH AH0 L OW1\nHELLO(1)  HH EH0 L OW1\n'
                    "'TIS  T IH1 Z\nBAD  XX YY\nWORLD  W ER1 L D\n", encoding='latin-1')
    for keep in (True, False):
        ours, theirs = cmudict.CMUDict(str(path), keep), jax_cmudict.CMUDict(str(path), keep)
        assert len(ours) == len(theirs)
        for word in ('hello', "'tis", 'bad', 'world', 'missing'):
            assert ours.lookup(word) == theirs.lookup(word)


def _record(*args, **kwargs):
    return args, kwargs


def recipe(dataset: str, meta_dir: str, batch_size: int = 16, lr: float = 2e-4,
           mpd_pallas: bool = False, msd_pallas: int = -1, tag=None):
    return dict(dataset=dataset, meta_dir=meta_dir, batch_size=batch_size, lr=lr,
                mpd_pallas=mpd_pallas, msd_pallas=msd_pallas, tag=tag)


class Commands:
    def run(self, name: str, times: int = 1, scale=1.0):
        return name, times, scale


@pytest.mark.parametrize('argv', [
    ['vctk', 'meta', '--batch_size', '4', '--lr=1e-3', '--mpd_pallas', 'true'],
    ['ljspeech', '/a/b', '--msd-pallas', '8', '--tag', '3.5', '--mpd_pallas=0'],
    ['vctk', 'm', '--tag', 'false', '--batch_size=2'],
    ['vctk', 'm', '--tag=7', '--mpd_pallas', 'yes'],
    ['vctk', 'm', '--tag'],
])
def test_fire_like_parses_as_jax(argv):
    """The same argv makes the same call: positional and --key / --key=value
    arguments, '-' in keys, annotated types, untyped literals, a bare flag."""
    assert cli.fire_like(recipe, argv) == jax_cli.fire_like(recipe, argv)
    assert cli.fire_like(_record, argv) == jax_cli.fire_like(_record, argv)
    cmd = ['run', 'x', '--times', '3', '--scale', '0.25']
    assert cli.fire_like(Commands, cmd) == jax_cli.fire_like(Commands, cmd)
