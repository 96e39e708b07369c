"""The port's Korean text layer against the JAX package's on the CPU: the
Korean cases of tests/test_text.py (graph2phone, the KoG2P rules and the full
rulebook's golden outputs, the codecs, the phone inventory, the classic
KoG2P names) and the two Zeroth-Korean cases of tests/test_medleydb_zeroth.py,
each also held equal to the JAX package's output: the G2P, the codecs and the
Zeroth metas (rows and bytes) exactly."""

import os
import random

import numpy as np
import pytest

from pytorch_sound_tpu.data.korean import g2p as jax_g2p
from pytorch_sound_tpu.scripts.preprocess import Processor as JaxProcessor
from pytorch_sound_tpu.utils import text as jax_text
from pytorch_sound_tpu_torch import settings
from pytorch_sound_tpu_torch.data.korean import PHONEMES
from pytorch_sound_tpu_torch.data.korean.g2p import KoG2P, graph2phone
from pytorch_sound_tpu_torch.data.meta import read_table_json
from pytorch_sound_tpu_torch.data.meta.zeroth_korean import ZerothKoreanMeta
from pytorch_sound_tpu_torch.scripts.preprocess import Processor
from pytorch_sound_tpu_torch.utils import text as text_utils
from pytorch_sound_tpu_torch.utils.wavio import write_wav

ASSETS = os.path.join(os.path.dirname(__file__), '..', 'assets')

GOLDEN = {
    '학교에 갑니다': 'h0 aa kf kk yo ee k0 aa mf nn ii t0 aa',
    '안녕하세요': 'aa nf nn yv ng h0 aa s0 ee yo',
    '같이 읽어요': 'k0 aa ch ii ii ll k0 vv yo',
    '물고기': 'mm uu ll kk oo k0 ii',
    '좋은 날씨네요': 'c0 oo xx nf nn aa ll ss ii nn ee yo',
    '신여성': 's0 ii nf nn yv s0 vv ng',
    '값이 비싸요': 'k0 aa pf ss ii p0 ii ss aa yo',
    '한국어 음성 합성': 'h0 aa nf k0 uu k0 vv xx mf s0 vv ng h0 aa pf ss vv ng',
    '몇 리': 'mm yv tf rr ii',
    '닭고기와 밥': 't0 aa kf kk oo k0 ii wa p0 aa pf',
}


def _hangul(rng, n):
    """n random syllables from the whole precomposed block, with spaces and
    a Latin letter mixed in."""
    chars = [chr(0xAC00 + int(c)) for c in rng.integers(0, 11172, n)]
    for i in rng.integers(0, n, max(1, n // 5)):
        chars[i] = ' ' if i % 2 else 'A'
    return ''.join(chars)


def test_vocab_sizes_match_reference():
    assert settings.KOR_PHN_SIZE == 47
    assert settings.KOR_GRP_SIZE == 63


def test_graph2phone_basic():
    assert graph2phone('한국') == 'h0aanf-k0uukf'
    assert graph2phone('아') == 'aa'
    assert graph2phone('강') == 'k0aang'


def test_kog2p_core_rules():
    g2p = KoG2P()
    assert g2p.g2p('좋다').split() == ['c0', 'oo', 'th', 'aa']
    assert g2p.g2p('국민').split() == ['k0', 'uu', 'ng', 'mm', 'ii', 'nf']
    assert g2p.g2p('같이').split() == ['k0', 'aa', 'ch', 'ii']
    assert g2p.g2p('옷이').split() == ['oo', 's0', 'ii']
    assert g2p.g2p('신라').split() == ['s0', 'ii', 'll', 'rr', 'aa']
    assert g2p.g2p('학교').split() == ['h0', 'aa', 'kf', 'kk', 'yo']


def test_kog2p_full_rulebook_golden():
    g2p = KoG2P()
    for text, expected in GOLDEN.items():
        assert g2p.g2p(text) == expected, text


@pytest.mark.parametrize('rulebook', ['rulebook.txt', 'korean_rules.txt'])
def test_g2p_matches_jax(rulebook):
    """Both rulebooks, the golden texts and 40 random syllable strings: the
    port's romanization and pronunciation equal the JAX package's."""
    path = os.path.join(ASSETS, rulebook)
    port, ref = KoG2P(path), jax_g2p.KoG2P(path)
    rng = np.random.default_rng(0)
    texts = list(GOLDEN) + [_hangul(rng, int(n)) for n in rng.integers(1, 12, 40)]
    for text in texts:
        assert graph2phone(text) == jax_g2p.graph2phone(text), text
        assert port.g2p(text) == ref.g2p(text), text


def test_kor_codecs_roundtrip():
    phones = 'k0 aa ch ii'
    idx = text_utils.kor_p2i(phones)
    assert text_utils.kor_i2p(idx) == phones.split()
    grp = text_utils.kor_text2grp('한글')
    idx = text_utils.kor_g2i(grp)
    assert len(idx) == 6  # 2 syllables x 3 jamo


def test_kor_codecs_match_jax():
    rng = np.random.default_rng(1)
    g2p = KoG2P()
    for n in rng.integers(1, 10, 20):
        text = _hangul(rng, int(n))
        phones = g2p.g2p(text)
        grp = text_utils.kor_text2grp(text)
        assert grp == jax_text.kor_text2grp(text)
        assert text_utils.kor_grp2text(grp) == jax_text.kor_grp2text(grp) == \
            jax_text.kor_grp2text(jax_text.kor_text2grp(text))
        for port_fn, jax_fn, arg in (
                (text_utils.kor_p2i, jax_text.kor_p2i, phones),
                (text_utils.kor_g2i, jax_text.kor_g2i, grp)):
            assert port_fn(arg) == jax_fn(arg)
        p_idx, g_idx = text_utils.kor_p2i(phones), text_utils.kor_g2i(grp)
        assert text_utils.kor_i2p(p_idx) == jax_text.kor_i2p(p_idx)
        assert text_utils.kor_i2g(g_idx) == jax_text.kor_i2g(g_idx)
        np.testing.assert_array_equal(text_utils.pad_korp_eos(p_idx),
                                      jax_text.pad_korp_eos(p_idx))
        np.testing.assert_array_equal(text_utils.pad_korg_eos(g_idx),
                                      jax_text.pad_korg_eos(g_idx))


def test_kophn_dict_matches_phoneme_inventory():
    phones = open(os.path.join(ASSETS, 'kophn_dict.txt')).read().split()
    assert phones == sorted(p for p in PHONEMES if p != '_')


def test_kog2p_classic_aliases():
    from pytorch_sound_tpu_torch.data.korean.g2p import (
        DEFAULT_RULEBOOK_PATH, addPhoneBoundary, addSpace, checkCharType,
        isHangul, phone2prono, readRules)
    assert os.path.realpath(DEFAULT_RULEBOOK_PATH) == os.path.realpath(
        jax_g2p.DEFAULT_RULEBOOK_PATH)
    ri, ro = readRules(DEFAULT_RULEBOOK_PATH)
    assert len(ri) == len(ro) > 50
    assert isHangul(ord('학')) and not isHangul(ord('A'))
    assert checkCharType([ord('학'), 32, ord('A')]) == [0, 1, -1]
    assert addSpace('p0aa') == 'p0 aa'
    assert addPhoneBoundary('p0aa').count(',') == 2
    assert phone2prono('p0aa,', ri, ro) == jax_g2p.phone2prono('p0aa,', ri, ro)


def _tone(sr, seconds, freq, seed=0):
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * freq * t)
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope='module')
def zeroth_roots(tmp_path_factory):
    """tests/test_medleydb_zeroth.py's Zeroth tree, processed by the port's
    and by the JAX package's Processor.zeroth_korean from the same split
    seed: (port out dir, JAX out dir)."""
    in_dir = str(tmp_path_factory.mktemp('zeroth_in'))
    texts = {
        '103_001_0001': '안녕하세요',
        '103_001_0002': '한국어 음성 합성',
        '205_003_0001': '좋은 날씨네요',
        '205_003_0002': '물고기',
    }
    sr = 22050
    for i, key in enumerate(texts):
        spk, book = key.split('_')[0], key.split('_')[1]
        d = os.path.join(in_dir, 'train_data_01', spk, '{}_{}'.format(spk, book))
        os.makedirs(d, exist_ok=True)
        write_wav(os.path.join(d, key + '.wav'), _tone(sr, 2.5, 150 + 30 * i), sr)
    for key, text in texts.items():
        spk, book = key.split('_')[0], key.split('_')[1]
        d = os.path.join(in_dir, 'train_data_01', spk, '{}_{}'.format(spk, book))
        with open(os.path.join(d, '{}_{}.trans.txt'.format(spk, book)), 'a',
                  encoding='utf-8') as w:
            w.write('{} {}\n'.format(key, text))
    outs = []
    for processor, name in ((Processor, 'port'), (JaxProcessor, 'jax')):
        out_dir = str(tmp_path_factory.mktemp('zeroth_' + name))
        random.seed(0)
        processor.zeroth_korean(in_dir, out_dir)
        outs.append(out_dir)
    return outs


def test_zeroth_korean_pipeline_end_to_end(zeroth_roots):
    root = zeroth_roots[0]
    meta = ZerothKoreanMeta(os.path.join(root, 'meta', 'all_meta.json')).meta
    assert len(meta) == 4
    assert set(meta['speaker'].values) == {0, 1}
    row = [i for i, t in enumerate(meta['text']) if '물고기' in t][0]
    assert meta['phoneme'][row] == 'mm uu ll kk oo k0 ii'
    assert len([f for f in os.listdir(os.path.join(root, 'wavs')) if f.endswith('.wav')]) == 4


def test_zeroth_phonemes_within_inventory(zeroth_roots):
    inventory = set(open(os.path.join(ASSETS, 'kophn_dict.txt')).read().split())
    meta = read_table_json(os.path.join(zeroth_roots[0], 'meta', 'all_meta.json'))
    used = {p for phns in meta['phoneme'] for p in phns.split()}
    assert used and used <= inventory


@pytest.mark.parametrize('name', ['all_meta.json', 'train_meta.json', 'val_meta.json'])
def test_zeroth_metas_match_jax(zeroth_roots, name):
    """Each meta file is the JAX package's byte for byte, its output paths
    aside; the wavs are the same bytes."""
    port, ref = zeroth_roots
    texts = [open(os.path.join(root, 'meta', name), 'rb').read().decode('ascii')
             .replace(root.replace('/', '\\/'), 'ROOT') for root in (port, ref)]
    assert texts[0] == texts[1]
    for wav in sorted(os.listdir(os.path.join(ref, 'wavs'))):
        assert open(os.path.join(port, 'wavs', wav), 'rb').read() == \
            open(os.path.join(ref, 'wavs', wav), 'rb').read()
