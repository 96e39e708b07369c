"""The port's data layer against the JAX package's, on synthetic fixtures (no
downloads): the cases of tests/test_data.py that need no dsd100, run on the
port, then parity with JAX — the meta files each package writes (bytes, the
train / val split after ``random.seed``), each reading the other's metas to
the same rows in the same order, and a whole epoch of VCTK batches bit for
bit after ``np.random.seed`` at ``num_workers=0``."""

import io
import os
import random

import numpy as np
import pandas as pd
import pytest

from pytorch_sound_tpu.data.meta.libri_tts import LibriTTSMeta as JaxLibriTTSMeta
from pytorch_sound_tpu.data.meta.vctk import VCTKMeta as JaxVCTKMeta
from pytorch_sound_tpu.data.meta.vctk import get_datasets as jax_vctk_datasets
from pytorch_sound_tpu_torch.data import meta as meta_mod
from pytorch_sound_tpu_torch.data.dataset import (BucketRandomBatchSampler,
                                                  SpeechDataLoader, SpeechDataset)
from pytorch_sound_tpu_torch.data.meta import MetaTable, preprocess_text
from pytorch_sound_tpu_torch.data.meta.commons import split_train_val_frame
from pytorch_sound_tpu_torch.data.meta.libri_tts import LibriTTSMeta, get_speakers
from pytorch_sound_tpu_torch.data.meta.vctk import VCTKMeta, get_datasets as vctk_datasets
from pytorch_sound_tpu_torch.data.meta.voice_bank import (VoiceBankMeta,
                                                          get_datasets as vb_datasets)
from pytorch_sound_tpu_torch.utils.wavio import write_wav

SR = 22050
FILES = ['all_meta.json', 'train_meta.json', 'val_meta.json']


def _make_vctk_tree(root, n_speakers=3, n_utts=8, rng=None):
    rng = rng or np.random.default_rng(0)
    for s in range(n_speakers):
        spk = 'p%03d' % (225 + s)
        os.makedirs(os.path.join(root, spk, 'wav'), exist_ok=True)
        os.makedirs(os.path.join(root, spk, 'txt'), exist_ok=True)
        for u in range(n_utts):
            dur = rng.uniform(2.5, 5.0)
            wav = rng.standard_normal(int(SR * dur)).astype(np.float32) * 0.1
            key = '%s_%03d' % (spk, u)
            write_wav(os.path.join(root, spk, 'wav', key + '.wav'), wav, SR)
            with open(os.path.join(root, spk, 'txt', key + '.txt'), 'w') as w:
                w.write('hello number %d from speaker %s.' % (u, spk))


@pytest.fixture(scope='module')
def vctk_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('vctk_raw'))
    _make_vctk_tree(root)
    return root


@pytest.fixture(scope='module')
def vctk_meta_dir(tmp_path_factory, vctk_root):
    meta = str(tmp_path_factory.mktemp('vctk_meta'))
    random.seed(21)
    VCTKMeta(meta).make_meta(vctk_root)
    return meta


@pytest.fixture(scope='module')
def split_metas(tmp_path_factory):
    """(port meta dir, JAX meta dir) of one tree of 3 speakers x 12
    utterances (one validation row each), both made after random.seed(21)."""
    root = str(tmp_path_factory.mktemp('vctk_split_raw'))
    _make_vctk_tree(root, n_utts=12, rng=np.random.default_rng(9))
    out = []
    for cls, name in ((VCTKMeta, 'port'), (JaxVCTKMeta, 'jax')):
        out.append(str(tmp_path_factory.mktemp('vctk_split_' + name)))
        random.seed(21)
        cls(out[-1]).make_meta(root)
    return tuple(out)


# ------------------------------------------------- tests/test_data.py on the port

def test_vctk_make_meta_and_load(vctk_meta_dir):
    files = sorted(os.listdir(vctk_meta_dir))
    assert files == FILES
    meta = VCTKMeta(os.path.join(vctk_meta_dir, 'all_meta.json'))
    assert len(meta) == 24
    assert meta.num_speakers == 3
    durs = meta.meta['duration'].values
    assert (np.diff(durs) >= 0).all()


def test_speech_dataset_fields(vctk_meta_dir):
    meta = VCTKMeta(os.path.join(vctk_meta_dir, 'all_meta.json'))
    ds = SpeechDataset(meta)
    item = ds[0]
    # columns: audio, speaker, text (META 'duration' filtered)
    assert len(item) == 3
    wav, speaker, text = item
    assert isinstance(wav, np.ndarray) and wav.ndim == 1
    assert isinstance(speaker, int)
    assert isinstance(text, np.ndarray)  # eng_t2i indices with EOS


def test_speech_dataset_fix_len_and_mask(vctk_meta_dir):
    meta = VCTKMeta(os.path.join(vctk_meta_dir, 'all_meta.json'))
    ds = SpeechDataset(meta, fix_len=SR, audio_mask=True)
    wav, speaker, text, mask = ds[3]
    assert len(wav) == SR
    assert mask.shape == wav.shape and (mask == 1).all()


def test_speech_dataset_extra_features(vctk_meta_dir):
    meta = VCTKMeta(os.path.join(vctk_meta_dir, 'all_meta.json'))
    ds = SpeechDataset(meta, fix_len=SR,
                       extra_features=[('audio_filename', lambda w: np.float64(np.abs(w).mean()))])
    item = ds[0]
    assert len(item) == 4
    assert item[3] > 0
    with pytest.raises(ValueError, match='extra_feature'):
        SpeechDataset(meta, extra_features=[('nope', len)])


def test_vctk_get_datasets_iteration(vctk_meta_dir):
    train_loader, valid_loader = vctk_datasets(vctk_meta_dir, batch_size=2,
                                               num_workers=0, fix_len=0)
    n = 0
    for batch in train_loader:
        wav, speaker, text = batch
        assert wav.ndim == 2 and wav.shape[0] == 2
        assert speaker.dtype == np.int64
        n += 1
    assert n == len(train_loader)
    for batch in valid_loader:
        pass


def test_loader_threaded_prefetch(vctk_meta_dir):
    train_loader, _ = vctk_datasets(vctk_meta_dir, batch_size=2, num_workers=2)
    batches = list(train_loader)
    assert len(batches) == len(train_loader)


def test_pad_multiple_quantizes_time_axis(vctk_meta_dir):
    train_loader, _ = vctk_datasets(vctk_meta_dir, batch_size=4, num_workers=0,
                                    pad_multiple=16384)
    shapes = set()
    n_batches = 0
    for batch in train_loader:
        assert batch[0].shape[-1] % 16384 == 0
        shapes.add(batch[0].shape[-1])
        n_batches += 1
    # quantized padding collapses near-equal bucket lengths onto shared shapes
    assert len(shapes) < n_batches


def test_bucket_sampler_batches():
    class FakeDS:
        def __len__(self):
            return 103

    s = BucketRandomBatchSampler(FakeDS(), n_buckets=5, batch_size=4)
    batches = list(iter(s))
    assert len(batches) == len(s)
    assert all(len(b) == 4 for b in batches)
    # batches come from contiguous (length-sorted) buckets
    for b in batches:
        assert max(b) - min(b) < s.bucket_size
    with pytest.raises(ValueError, match='too small'):
        BucketRandomBatchSampler(FakeDS(), n_buckets=26, batch_size=4)


def test_pad_collate_int_and_ragged():
    batch = [[np.ones(5, np.float32), 3], [np.ones(7, np.float32), 4]]
    out = SpeechDataLoader.pad_collate_fn(batch)
    assert out[0].shape == (2, 7)
    assert out[0][0, 5:].sum() == 0
    np.testing.assert_array_equal(out[1], [3, 4])

    out = SpeechDataLoader.pad_collate_fn(batch, pad_multiple=8)
    assert out[0].shape == (2, 8)


def test_preprocess_text_filter(tmp_path):
    p = os.path.join(tmp_path, 't.txt')
    with open(p, 'w') as w:
        w.write('  Hello, world! 123 #$%  ')
    txt, passed = preprocess_text((p, 0, 3.0))
    assert passed
    assert '#' not in txt and 'Hello, world!' in txt
    # unreadable file -> fail
    txt, passed = preprocess_text((os.path.join(tmp_path, 'missing.txt'), 0, 3.0))
    assert not passed and txt == ''


def test_split_train_val_stratified():
    table = MetaTable({'speaker': [0] * 20 + [1] * 20, 'x': list(range(40))})
    train, val = split_train_val_frame(table, val_rate=0.25)
    assert len(val) == 10 and len(train) == 30
    assert set(val['speaker']) == {0, 1}   # stratified over speakers
    # an explicit stream: the same split for the same seed
    a = split_train_val_frame(table, 0.25, rng=random.Random(4))[1]['x']
    assert a == split_train_val_frame(table, 0.25, rng=random.Random(4))[1]['x']


@pytest.fixture(scope='module')
def voicebank_meta_dir(tmp_path_factory):
    rng = np.random.default_rng(1)
    root = str(tmp_path_factory.mktemp('vb_raw'))
    meta = str(tmp_path_factory.mktemp('vb_meta'))
    for phase in ('trainset', 'validset'):
        for kind in ('clean', 'noisy'):
            os.makedirs(os.path.join(root, '%s_%s_wav' % (phase, kind)), exist_ok=True)
    txt_dir = os.path.join(root, 'testset_txt')
    os.makedirs(txt_dir, exist_ok=True)
    for phase, spk_base in (('trainset', 230), ('validset', 240)):
        for s in range(2):
            for u in range(4):
                key = 'p%03d_%03d' % (spk_base + s, u)
                dur = rng.uniform(2.5, 4.0)
                clean = rng.standard_normal(int(SR * dur)).astype(np.float32) * 0.1
                noisy = clean + 0.05 * rng.standard_normal(len(clean)).astype(np.float32)
                write_wav(os.path.join(root, '%s_clean_wav' % phase, key + '.wav'), clean, SR)
                write_wav(os.path.join(root, '%s_noisy_wav' % phase, key + '.wav'), noisy, SR)
                with open(os.path.join(txt_dir, key + '.txt'), 'w') as w:
                    w.write('utterance %d.' % u)
    VoiceBankMeta(meta).make_meta(root, 2, 15, 0)
    return meta


def test_voicebank_pipeline(voicebank_meta_dir):
    train_loader, valid_loader = vb_datasets(voicebank_meta_dir, batch_size=2,
                                             num_workers=0, fix_len=16384)
    assert (len(train_loader.dataset), len(valid_loader.dataset)) == (8, 8)
    noisy, clean, speaker, text = next(iter(train_loader))
    assert noisy.shape == clean.shape == (2, 16384)
    # the shared random crop start keeps noisy/clean aligned
    assert np.corrcoef(noisy[0], clean[0])[0, 1] > 0.8


# ------------------------------------------------------------- parity with JAX

def _rows(table, columns):
    """Each column's values in row order, as plain Python values."""
    return {c: [v.item() if hasattr(v, 'item') else v for v in table[c].values]
            for c in columns}


def test_meta_files_equal_jax_bytes(split_metas):
    """After ``random.seed(21)`` both packages' ``make_meta`` write the same
    three files, byte for byte: the same rows, train / val split, key order,
    escapes and float text."""
    for name in FILES:
        with open(os.path.join(split_metas[0], name), 'rb') as a, \
                open(os.path.join(split_metas[1], name), 'rb') as b:
            assert a.read() == b.read(), name
    val = VCTKMeta(os.path.join(split_metas[0], 'val_meta.json'))
    assert len(val) == 3 and val.num_speakers == 3


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('name', FILES)
def test_metas_cross_read(writer, name, split_metas, tmp_path):
    """A meta written by either package reads back, in both, to the same
    rows in the same order (the duration sort included). The port's copy
    of the JAX file is rewritten by pandas first, so both readers see a
    file the JAX package itself wrote from the port's."""
    path = os.path.join(split_metas[0] if writer == 'port' else split_metas[1], name)
    if writer == 'port':
        frame = pd.read_json(path)
        path = str(tmp_path / name)
        frame.to_json(path)
    port, jax_meta = VCTKMeta(path), JaxVCTKMeta(path)
    columns = ['speaker', 'audio_filename', 'text', 'pass', 'duration']
    assert list(port.meta.columns) == list(jax_meta.meta.columns) == columns
    assert list(port.meta.index) == list(jax_meta.meta.index)
    assert _rows(port.meta, columns) == _rows(jax_meta.meta, columns)


def test_table_json_is_pandas_to_json(tmp_path):
    """The writer gives ``DataFrame.to_json``'s bytes and the reader
    ``pd.read_json``'s values, bit for bit, on floats of every magnitude,
    text with '/', quotes and non-ASCII, ints, bools and integral floats."""
    rng = np.random.default_rng(4)
    floats = np.concatenate([rng.uniform(0, 10, 300), rng.uniform(0, 1e-4, 50),
                             10.0 ** rng.uniform(-14, 15, 50), -rng.uniform(0, 5, 20),
                             [0.0, 2.0, 4.99999999995, 9.99999999996, 1e17, 2.5e-5,
                              0.1, 1 / 3, 123456789012.5]])
    n = len(floats)
    data = {'duration': list(floats), 'speaker': list(range(n)),
            'pass': [bool(i % 3) for i in range(n)],
            'text': ['a/b "c" é ü %d\t' % i for i in range(n)],
            'whole': [float(i) for i in range(n)]}
    keys = ['p%03d_%03d' % (i // 7, i) for i in range(n)]
    text = meta_mod.table_json(MetaTable(data, index=keys))
    assert text == pd.DataFrame(data, index=keys).to_json()
    path = str(tmp_path / 't.json')
    meta_mod.write_table_json(MetaTable(data, index=keys), path)
    ours, theirs = meta_mod.read_table_json(path), pd.read_json(io.StringIO(text))
    assert ours.index == list(theirs.index)
    for c in data:
        got, ref = ours[c].values, theirs[c].to_numpy()
        assert got.dtype.kind == ref.dtype.kind or (got.dtype == object and ref.dtype.kind in 'OTU'), c
        assert [x for x in got] == [x for x in ref], c
    # integer row keys (a RangeIndex) come back as ints, as pandas reads them
    assert meta_mod.read_table_json(path).index == keys
    meta_mod.write_table_json(MetaTable({'x': [1.5, 2.5]}), path)
    assert meta_mod.read_table_json(path).index == [0, 1] == list(pd.read_json(path).index)


def _epoch(loaders):
    """Every batch of one pass over each loader, in order."""
    return [[np.array(x) for x in batch] for loader in loaders for batch in loader]


@pytest.mark.parametrize('fix_len,pad_multiple', [(0, 1), (0, 16384), (SR, 1), (8192, 8192)])
def test_vctk_batches_equal_jax(split_metas, fix_len, pad_multiple):
    """With ``np.random.seed(s)`` at ``num_workers=0``, one epoch of the
    port's VCTK train and valid loaders equals the JAX package's, bit for
    bit: bucket shuffles and choices, crops, padding, dtypes."""
    out = []
    for datasets in (vctk_datasets, jax_vctk_datasets):
        np.random.seed(7)
        out.append(_epoch(datasets(split_metas[1], batch_size=2, num_workers=0,
                                   fix_len=fix_len, pad_multiple=pad_multiple)))
    port, ref = out
    assert len(port) == len(ref) == 15 + 2     # train (5 buckets of 3 batches), valid
    for a, b in zip(port, ref):
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize('bucket', [True, False])
def test_loader_resumes_its_epoch(vctk_meta_dir, bucket):
    """``state_dict`` after k batches, with the numpy state beside it, puts a
    fresh loader where the first one was: the rest of the epoch and the
    next epoch come out the same."""
    meta = VCTKMeta(os.path.join(vctk_meta_dir, 'train_meta.json'))

    def loader():
        return SpeechDataLoader(SpeechDataset(meta, fix_len=4096), batch_size=2,
                                is_bucket=bucket, is_shuffle=True, n_buckets=3)
    np.random.seed(3)
    first = loader()
    it = iter(first)
    for _ in range(3):
        next(it)
    state, np_state = first.state_dict(), np.random.get_state()
    rest = [b[0] for b in it] + [b[0] for b in first]
    np.random.seed(99)
    second = loader()
    next(iter(second))                    # a draw the restore discards
    second.load_state_dict(state)
    np.random.set_state(np_state)
    again = [b[0] for b in second] + [b[0] for b in second]
    assert len(rest) == len(again) == 2 * len(first) - 3
    assert all(np.array_equal(a, b) for a, b in zip(rest, again))


def test_libri_tts_meta_equals_jax(tmp_path):
    """LibriTTS (rows keyed 0 .. n - 1, the declared columns first) writes
    JAX's bytes after ``random.seed``, and reads back its speakers."""
    rng = np.random.default_rng(8)
    root = tmp_path / 'libri'
    for spk in ('19', '26', '32'):
        for d in ('wav', 'txt'):
            os.makedirs(root / spk / d)
        for u in range(10):
            write_wav(str(root / spk / 'wav' / ('%s_%d.wav' % (spk, u))),
                      (rng.standard_normal(int(SR * rng.uniform(2.2, 4))) * 0.1
                       ).astype(np.float32), SR, dtype='int16')
            (root / spk / 'txt' / ('%s_%d.txt' % (spk, u))).write_text('a short line %d' % u)
    for cls, out in ((LibriTTSMeta, 'port'), (JaxLibriTTSMeta, 'jax')):
        random.seed(5)
        cls(str(tmp_path / out)).make_meta(str(root), 2, 15, 0.5)
    for name in FILES:
        assert (tmp_path / 'port' / name).read_bytes() == (tmp_path / 'jax' / name).read_bytes()
    assert get_speakers(str(tmp_path / 'port')) == 3


def test_explicit_streams_leave_the_global_one_alone(vctk_meta_dir):
    """Given ``np.random.RandomState``s, the dataset's crops and the loader's
    bucket draws come from them: the same seeds give the same epoch whatever
    the global stream holds, and the global stream is not drawn."""
    meta = VCTKMeta(os.path.join(vctk_meta_dir, 'train_meta.json'))

    def epoch():
        loader = SpeechDataLoader(
            SpeechDataset(meta, fix_len=4096, rng=np.random.RandomState(1)),
            batch_size=2, is_bucket=True, n_buckets=3, rng=np.random.RandomState(2))
        return [b[0] for b in loader]
    np.random.seed(0)
    first = epoch()
    state = np.random.get_state()[1].copy()
    np.random.seed(123)
    second = epoch()
    np.random.seed(0)
    assert np.array_equal(np.random.get_state()[1], state)
    assert len(first) == len(second) > 0
    assert all(np.array_equal(a, b) for a, b in zip(first, second))
