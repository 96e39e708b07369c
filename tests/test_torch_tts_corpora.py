"""The port's TTS-corpus preprocessing against the JAX package's on the CPU:
tests/test_utils.py's silence split with the port's ``utils.silence`` equal
to JAX's, and the Processor commands ``libri_tts`` (with ``fetch_structure``),
``libri_tts_fetch_speaker``, ``libri_light`` and ``libri_light2`` run by both
packages on one tiny tree: the same files and the same meta rows, byte for
byte, output paths aside."""

import json
import os
import random
import shutil

import numpy as np
import pytest

from pytorch_sound_tpu.scripts.preprocess import Processor as JaxProcessor
from pytorch_sound_tpu.utils import silence as jax_silence
from pytorch_sound_tpu_torch.data.meta import read_table_json
from pytorch_sound_tpu_torch.scripts.preprocess import Processor
from pytorch_sound_tpu_torch.utils import silence
from pytorch_sound_tpu_torch.utils.wavio import write_wav

SR = 22050
META_FILES = ('all_meta.json', 'train_meta.json', 'val_meta.json')


def test_silence_split():
    sr = 1000
    loud = np.sin(np.linspace(0, 100, sr)).astype(np.float32)
    quiet = np.zeros(sr, dtype=np.float32)
    seg = np.concatenate([loud, quiet, loud])
    chunks = silence.split_on_silence(seg, min_silence_len=500, silence_thresh=-30,
                                      keep_silence=10)
    assert len(chunks) == 2
    assert all(len(c) > sr // 2 for c in chunks)
    assert len(silence.split_on_silence(loud, 500, -30, 0)) == 1


@pytest.mark.parametrize('seek_step', [1, 7, 250])
def test_silence_matches_jax(seek_step):
    """Noise bursts between quiet gaps of random lengths: the same silent
    and non-silent ranges and chunks as the JAX package's."""
    rng = np.random.default_rng(seek_step)
    parts = []
    for _ in range(6):
        parts.append(0.3 * rng.standard_normal(int(rng.integers(200, 3000))))
        parts.append(1e-4 * rng.standard_normal(int(rng.integers(100, 2500))))
    seg = np.concatenate(parts).astype(np.float32)
    for min_len, thresh in ((500, -40), (1000, -30), (50, -60)):
        assert silence.detect_silence(seg, min_len, thresh, seek_step) == \
            jax_silence.detect_silence(seg, min_len, thresh, seek_step)
        assert silence.detect_nonsilent(seg, min_len, thresh, seek_step) == \
            jax_silence.detect_nonsilent(seg, min_len, thresh, seek_step)
        ours = silence.split_on_silence(seg, min_len, thresh, 20, seek_step)
        ref = jax_silence.split_on_silence(seg, min_len, thresh, 20, seek_step)
        assert len(ours) == len(ref) and all(np.array_equal(a, b) for a, b in zip(ours, ref))
    assert silence.rms(seg) == jax_silence.rms(seg)
    assert silence.db_to_float(-23.0, False) == jax_silence.db_to_float(-23.0, False)


def _same_tree(port, ref):
    """Equal relative file lists, and equal bytes with each root's path
    replaced (meta JSON escapes '/' as '\\/')."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(port) == files(ref)
    for rel in files(ref):
        blobs = []
        for root in (port, ref):
            blob = open(os.path.join(root, rel), 'rb').read()
            if rel.endswith('.json'):
                for r in (root, os.path.dirname(root)):
                    blob = blob.replace(r.replace('/', '\\/').encode(), b'ROOT')
            blobs.append(blob)
        assert blobs[0] == blobs[1], rel


def _speech(rng, seconds, gaps=()):
    """A tone burst train of ``seconds`` with exact silences at ``gaps``
    ((start, end) seconds)."""
    t = np.arange(int(SR * seconds)) / SR
    wav = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 300) * t) * (
        1 + 0.2 * np.sin(2 * np.pi * 3 * t))
    for a, b in gaps:
        wav[int(a * SR):int(b * SR)] = 0.0
    return wav.astype(np.float32)


@pytest.fixture(scope='module')
def libri_tts_roots(tmp_path_factory):
    """A LibriTTS tree (train-clean-100: 2 speakers x 2 books x 3
    utterances, dev-clean: 1 speaker), copied and processed by each
    package's libri_tts from the same split seed, then each one's metas
    joined with one SPEAKERS.txt: [(port in, port out), (JAX in, JAX out)]."""
    base = tmp_path_factory.mktemp('libri_tts')
    raw = os.path.join(str(base), 'raw')
    rng = np.random.default_rng(0)
    for subset, speakers in (('train-clean-100', ('19', '26')), ('dev-clean', ('84',))):
        for spk in speakers:
            for book in ('198', '495'):
                d = os.path.join(raw, subset, spk, book)
                os.makedirs(d)
                for u in range(3):
                    key = '%s_%s_%06d_000000' % (spk, book, u)
                    write_wav(os.path.join(d, key + '.wav'),
                              _speech(rng, rng.uniform(2.2, 3.5)), SR, dtype='int16')
                    for kind in ('normalized', 'original'):
                        with open(os.path.join(d, '%s.%s.txt' % (key, kind)), 'w') as f:
                            f.write('The %s text, number %d of book %s.' % (kind, u, book))
    speakers_txt = os.path.join(str(base), 'SPEAKERS.txt')
    with open(speakers_txt, 'w') as f:
        f.write('READER\tGENDER\tSUBSET\tNAME\n')
        for spk, gender, name in (('19', 'F', 'Kara Shallenberg'), ('26', 'M', 'Denny Sayers'),
                                  ('84', 'F', 'Christie Nowak')):
            f.write('%s\t%s\ttrain-clean-100\t%s\n' % (spk, gender, name))
    roots = []
    for processor, name in ((Processor, 'port'), (JaxProcessor, 'jax')):
        in_dir, out_dir = (os.path.join(str(base), name + sub) for sub in ('_in', '_out'))
        shutil.copytree(raw, in_dir)
        random.seed(0)
        processor.libri_tts(in_dir, out_dir)
        processor.libri_tts_fetch_speaker(os.path.join(out_dir, 'meta'), speakers_txt)
        roots.append((in_dir, out_dir))
    return roots


def test_libri_tts_matches_jax(libri_tts_roots):
    (port_in, port_out), (jax_in, jax_out) = libri_tts_roots
    _same_tree(port_in, jax_in)
    _same_tree(port_out, jax_out)
    meta = read_table_json(os.path.join(port_out, 'meta', 'all_meta_add.json'))
    assert len(meta) == 12 and set(meta['NAME']) == {'Kara Shallenberg', 'Denny Sayers'}
    assert sorted(os.listdir(os.path.join(port_in, 'valid'))) == ['84']


@pytest.fixture(scope='module')
def libri_light_roots(tmp_path_factory):
    """A Libri-Light tree (2 speakers, 3 files with voice-activity JSON; one
    7 s span with a 1 s silence inside), processed by each package's
    libri_light and then libri_light2 (max 4 s, min 0.5 s):
    [port out, JAX out]."""
    base = tmp_path_factory.mktemp('libri_light')
    raw = os.path.join(str(base), 'raw')
    rng = np.random.default_rng(1)
    files = (('100', 'book_a', 'f1', 9.0, [[0.2, 7.2], [8.4, 8.9]]),
             ('100', 'book_b', 'f2', 4.0, [[0.0, 1.5], [1.6, 3.9]]),
             ('207', 'book_c', 'f3', 5.0, [[0.5, 4.5]]))
    for spk, book, name, seconds, vad in files:
        d = os.path.join(raw, spk, book)
        os.makedirs(d, exist_ok=True)
        write_wav(os.path.join(d, name + '.wav'), _speech(rng, seconds, [(3.5, 4.5)]), SR,
                  dtype='int16')
        with open(os.path.join(d, name + '.json'), 'w') as f:
            json.dump({'speaker': spk, 'voice_activity': vad, 'book_meta': {'id': book}}, f)
    outs = []
    for processor, name in ((Processor, 'port'), (JaxProcessor, 'jax')):
        out_dir = os.path.join(str(base), name)
        random.seed(0)
        processor.libri_light(raw, out_dir)
        random.seed(1)
        processor().libri_light2(os.path.join(out_dir, 'meta', 'all_meta.json'),
                                 os.path.join(out_dir, 'v2'), min_duration=0.5,
                                 max_duration=4.0)
        outs.append(out_dir)
    return outs


def test_libri_light_matches_jax(libri_light_roots):
    port, ref = libri_light_roots
    _same_tree(port, ref)
    meta = read_table_json(os.path.join(port, 'meta', 'all_meta.json'))
    assert len(meta) == 5 and sorted(set(meta['speaker'])) == [0, 1]
    assert json.load(open(os.path.join(port, 'meta', 'speaker_map.json'))) == \
        {'100': 0, '207': 1}


def test_libri_light2_rechunks_long_spans(libri_light_roots):
    """The 7 s span splits at its silence into two chunks of 0.5-4 s; the
    other spans keep their rows."""
    port = libri_light_roots[0]
    v2 = read_table_json(os.path.join(port, 'v2', 'meta', 'all_meta.json'))
    chunks = [p for p in v2['audio_filename'] if '/chunks/' in p]
    assert len(chunks) == 2 and len(v2) == 6
    assert all(0.5 <= d <= 4.0 for d in v2['duration'])
    for name in META_FILES:
        assert len(read_table_json(os.path.join(port, 'v2', 'meta', name))) == \
            {'all_meta.json': 6, 'train_meta.json': 6, 'val_meta.json': 0}[name]
