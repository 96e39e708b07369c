"""The port's preprocess script against the JAX package's, on the CPU:
tests/test_preprocess.py's nine cases on small trees. Host helpers and the
VCTK CLI write the JAX package's files; ``extract_features`` (K2's plain
version on the CPU, the JAX function's CPU route) writes JAX's features
within 1e-4 at the f32 wire, one bf16 ulp at bf16 and one quantisation step
at int8, at stages 2 and 3 and on every host -> device wire; ``dsd100``
keys its outputs by subset and song, and so stays right on the tree whose
Dev and Test songs share names, where the JAX copy races."""

import glob
import os
import struct

import jax

jax.config.update('jax_platforms', 'cpu')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.scripts import preprocess as jax_pre  # noqa: E402
from pytorch_sound_tpu.utils.cli import fire_like as jax_fire_like  # noqa: E402
from pytorch_sound_tpu_torch import settings  # noqa: E402
from pytorch_sound_tpu_torch.data.meta.dsd100 import DSD100Meta  # noqa: E402
from pytorch_sound_tpu_torch.parallel import process_shard_indices  # noqa: E402
from pytorch_sound_tpu_torch.scripts import preprocess as pre  # noqa: E402
from pytorch_sound_tpu_torch.scripts.preprocess import Processor  # noqa: E402
from pytorch_sound_tpu_torch.utils.cli import fire_like  # noqa: E402
from pytorch_sound_tpu_torch.utils.wavio import read_wav, read_wav_info, write_wav  # noqa: E402

SR_IN = 48000
SR_OUT = 22050
PAD = 2.0


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_rms_normalize():
    wav = (0.01 * np.sin(np.linspace(0, 100, 10000))).astype(np.float32)
    out = pre.rms_normalize(wav, target_db=-23.0)
    assert np.array_equal(out, jax_pre.rms_normalize(wav, target_db=-23.0))
    assert abs(20 * np.log10(np.sqrt(np.mean(out ** 2))) + 23.0) < 0.1
    z = np.zeros(100, np.float32)
    np.testing.assert_array_equal(pre.rms_normalize(z), z)


def test_process_all_resamples_and_normalizes(tmp_path):
    """The port's output file is the JAX package's, byte for byte (the same
    native resampler, the same gain); an existing output is kept."""
    rng = np.random.default_rng(0)
    in_path = str(tmp_path / 'in.wav')
    write_wav(in_path, (0.02 * rng.standard_normal(SR_IN * 2)).astype(np.float32), SR_IN)
    ours, theirs = str(tmp_path / 'port.wav'), str(tmp_path / 'jax.wav')
    pre.process_all(in_path, ours, SR_OUT)
    jax_pre.process_all(in_path, theirs, SR_OUT)
    assert open(ours, 'rb').read() == open(theirs, 'rb').read()
    wav, sr = read_wav(ours)
    assert sr == SR_OUT and abs(len(wav) - SR_OUT * 2) < 4
    write_wav(ours, np.zeros(10, np.float32), SR_OUT)
    pre.process_all(in_path, ours, SR_OUT)
    assert len(read_wav(ours)[0]) == 10


def _raw_vctk(raw, rng):
    for spk in ('p225', 'p226'):
        os.makedirs(os.path.join(raw, 'wav48', spk))
        os.makedirs(os.path.join(raw, 'txt', spk))
        for u in range(6):
            wav = (0.05 * rng.standard_normal(int(SR_IN * rng.uniform(2.5, 4.0))))
            key = '%s_%03d' % (spk, u)
            write_wav(os.path.join(raw, 'wav48', spk, key + '.wav'), wav.astype(np.float32),
                      SR_IN)
            with open(os.path.join(raw, 'txt', spk, key + '.txt'), 'w') as w:
                w.write('this is sentence %d.' % u)


def test_vctk_pipeline_via_cli(tmp_path):
    """Through the CLI: the same tree of files as the JAX package's CLI
    writes, wavs byte for byte, and metas naming the same utterances."""
    import random
    raw = str(tmp_path / 'raw')
    _raw_vctk(raw, np.random.default_rng(1))
    outs = {}
    for name, cli, proc in (('port', fire_like, Processor),
                            ('jax', jax_fire_like, jax_pre.Processor)):
        out = str(tmp_path / name)
        random.seed(0)
        cli(proc, ['vctk', raw, out, '--sample_rate', str(SR_OUT)])
        outs[name] = out
    assert _files(outs['port']) == _files(outs['jax'])
    assert sorted(os.listdir(os.path.join(outs['port'], 'meta'))) == [
        'all_meta.json', 'train_meta.json', 'val_meta.json']
    for rel in _files(outs['port']):
        a, b = (os.path.join(outs[k], rel) for k in ('port', 'jax'))
        if rel.endswith('.json'):
            assert (open(a).read().replace(outs['port'].replace('/', '\\/'), '')
                    == open(b).read().replace(outs['jax'].replace('/', '\\/'), '')), rel
        else:
            assert open(a, 'rb').read() == open(b, 'rb').read(), rel
        if rel.endswith('.wav'):
            assert read_wav_info(a)[0] == SR_OUT


def _dsd_tree(raw, rng, songs):
    sr = 44100
    for subset, names in songs.items():
        for song in names:
            mdir = os.path.join(raw, 'Mixtures', subset, song)
            sdir = os.path.join(raw, 'Sources', subset, song)
            os.makedirs(mdir)
            os.makedirs(sdir)
            v = (0.1 * rng.standard_normal(sr * 25)).astype(np.float32)
            b = (0.1 * rng.standard_normal(sr * 25)).astype(np.float32)
            write_wav(os.path.join(mdir, 'mixture.wav'), v + b, sr)
            write_wav(os.path.join(sdir, 'vocals.wav'), v, sr)


def test_dsd100_pipeline(tmp_path):
    """On the colliding tree of tests/test_preprocess.py (Dev and Test both
    hold s1 and s2), port only: every row satisfies mix == voc + bg, on
    every run, since outputs are keyed by subset and song. On a tree whose
    song names differ across subsets, the port's chunks equal JAX's."""
    import random
    raw = str(tmp_path / 'dsd')
    _dsd_tree(raw, np.random.default_rng(2), {'Dev': ('s1', 's2'), 'Test': ('s1', 's2')})
    for run in range(2):
        out = str(tmp_path / ('dsd_out%d' % run))
        fire_like(Processor, ['dsd100', raw, out, '--wav_subset_len', str(44100 * 10)])
        meta = DSD100Meta(os.path.join(out, 'meta', 'all_meta.json'))
        assert len(meta) == 8   # 4 songs x 2 chunks of 10 s from 25 s
        for i in range(len(meta)):
            row = meta.meta.iloc[i]
            mix, voc, bg = (np.load(row[k]) for k in ('mixture_filename', 'voice_filename',
                                                     'background_filename'))
            np.testing.assert_allclose(mix, voc + bg, atol=1e-6)
        assert os.path.isdir(os.path.join(out, 'Dev', 's1'))

    raw2 = str(tmp_path / 'dsd2')
    _dsd_tree(raw2, np.random.default_rng(3), {'Dev': ('d1',), 'Test': ('t1',)})
    random.seed(0)
    Processor.dsd100(raw2, str(tmp_path / 'port'), 44100 * 10)
    random.seed(0)
    jax_pre.Processor.dsd100(raw2, str(tmp_path / 'jax'), 44100 * 10)
    port = _files(str(tmp_path / 'port'))
    theirs = _files(str(tmp_path / 'jax'))
    assert sorted(os.path.join(os.path.basename(os.path.dirname(f)), os.path.basename(f))
                  for f in port if f.endswith('.npy')) == sorted(f for f in theirs
                                                                  if f.endswith('.npy'))
    for f in port:
        if f.endswith('.npy'):
            ref = os.path.join(str(tmp_path / 'jax'), *f.split(os.sep)[1:])
            assert np.array_equal(np.load(os.path.join(str(tmp_path / 'port'), f)),
                                  np.load(ref)), f
    meta = DSD100Meta(str(tmp_path / 'port' / 'meta' / 'all_meta.json'))
    assert len(meta) == 4


def test_partialize_npy(tmp_path):
    arr = np.arange(25, dtype=np.float32)
    for name, fn in (('port', pre.partialize_npy_wave), ('jax', jax_pre.partialize_npy_wave)):
        os.makedirs(tmp_path / name)
        np.save(str(tmp_path / name / 'a.npy'), arr)
        fn(str(tmp_path / name / 'a.npy'), 10, 10)
    path, parts = pre.partialize_npy_wave(str(tmp_path / 'port' / 'a.npy'), 10, 10)
    assert len(parts) == 2   # 25 -> 10, 10, (5 dropped below min)
    assert _files(str(tmp_path / 'port')) == _files(str(tmp_path / 'jax'))
    for f in _files(str(tmp_path / 'port')):
        assert np.array_equal(np.load(str(tmp_path / 'port' / f)),
                              np.load(str(tmp_path / 'jax' / f)))


def test_cli_help_and_unknown(capsys):
    fire_like(Processor, [])
    outp = capsys.readouterr().out
    assert 'vctk' in outp and 'voice_bank' in outp and 'extract_features' in outp
    with pytest.raises(SystemExit):
        fire_like(Processor, ['definitely_not_a_command'])


# ---------------------------------------------------------------- extract_features

def _fmt_only(path, sr):
    """A 16-bit mono header with no data chunk: the header read takes it,
    the native decoder cannot (its row is dropped)."""
    fmt = struct.pack('<HHIIHH', 1, 1, sr, sr * 2, 2, 16)
    with open(path, 'wb') as f:
        f.write(b'RIFF' + struct.pack('<I', 4 + 8 + len(fmt)) + b'WAVE')
        f.write(b'fmt ' + struct.pack('<I', len(fmt)) + fmt)


@pytest.fixture(scope='module')
def feature_tree(tmp_path_factory):
    """Three source rates (48 kHz int16, the 22.05 kHz no-resample group,
    44.1 kHz with a stereo file), lengths from 0.5 s to past the 2 s pad,
    a file the native decoder drops and one that is no WAV at all."""
    root = tmp_path_factory.mktemp('features')
    d = root / 'in'
    (d / 'spk').mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, sec in enumerate((1.0, 0.5, 2.4, 1.37, 0.73)):
        write_wav(str(d / 'spk' / ('a%d.wav' % i)),
                  (0.1 * rng.standard_normal(int(SR_IN * sec))).astype(np.float32), SR_IN,
                  dtype='int16')
    for i, n in enumerate((SR_OUT, SR_OUT + 1234, SR_OUT // 2)):
        write_wav(str(d / ('b%d.wav' % i)),
                  (0.1 * rng.standard_normal(n)).astype(np.float32), SR_OUT)
    write_wav(str(d / 'c0.wav'), (0.1 * rng.standard_normal((2, 44100))).astype(np.float32),
              44100, dtype='int16')
    write_wav(str(d / 'c1.wav'), (0.1 * rng.standard_normal(30000)).astype(np.float32),
              44100, dtype='int16')
    _fmt_only(str(d / 'spk' / 'broken.wav'), SR_IN)
    (d / 'noise.wav').write_bytes(b'not a wave file')
    return root


NAMES = ['a0', 'a1', 'a2', 'a3', 'a4', 'b0', 'b1', 'b2', 'c0', 'c1']


def _features(root, who, **kw):
    """{name: mel} of one extract_features run, cached per configuration."""
    tag = '%s_%s' % (who, '_'.join('%s%s' % kv for kv in sorted(kw.items())))
    out = root / tag
    if not out.exists():
        if who == 'port':
            stats = Processor.extract_features(str(root / 'in'), str(out), batch_size=2,
                                               pad_seconds=PAD, device='cpu', **kw)
            assert stats['utterances'] == len(NAMES) and stats['device'] == 'cpu'
        else:
            jax_pre.Processor.extract_features(str(root / 'in'), str(out), batch_size=2,
                                               pad_seconds=PAD, **kw)
    assert sorted(os.listdir(out)) == sorted(n + '.mel.npy' for n in NAMES)
    return {n: np.load(str(out / (n + '.mel.npy'))) for n in NAMES}


def _check_shapes(root, mels):
    for name, mel in mels.items():
        path = root / 'in' / ('spk' if name.startswith('a') else '') / (name + '.wav')
        sr, frames, _, _ = read_wav_info(str(path))
        n = pre.resample_out_len(min(frames, int(PAD * sr)), sr, SR_OUT)
        assert mel.shape == (settings.MEL_SIZE, n // settings.HOP_LENGTH + 1), name
        assert mel.dtype == np.float32 and np.isfinite(mel).all()


@pytest.mark.parametrize('stages', [2, 3])
def test_extract_features_overlapped(feature_tree, stages):
    """Both overlap structures write one (80, n // 256 + 1) mel per
    readable utterance, within 1e-4 of the JAX function's f32 wire."""
    ref = _features(feature_tree, 'jax', wire='f32')
    got = _features(feature_tree, 'port', wire='f32', stages=stages)
    _check_shapes(feature_tree, got)
    for name in NAMES:
        assert got[name].shape == ref[name].shape
        np.testing.assert_allclose(got[name], ref[name], atol=1e-4, err_msg=name)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def test_extract_features_bf16_wire_accuracy(feature_tree):
    """bf16 and int8 wires: within one bf16 ulp and one quantisation step of
    JAX's same wire, and within their own rounding of the f32 wire."""
    f32 = _features(feature_tree, 'port', wire='f32', stages=2)
    for wire in ('bf16', 'int8'):
        got = _features(feature_tree, 'port', wire=wire)
        ref = _features(feature_tree, 'jax', wire=wire)
        for name in NAMES:
            a, b, full = got[name], ref[name], f32[name]
            if wire == 'bf16':
                assert (np.abs(a - b) <= _bf16_ulp(np.maximum(np.abs(a), np.abs(b)))).all()
                assert (np.abs(a - full) <= _bf16_ulp(full)).all()
                assert np.array_equal(a, torch.from_numpy(a).bfloat16().float().numpy())
            else:
                step = (full.max() - full.min()) / 254
                assert np.abs(a - b).max() <= step + 1e-4, name
                assert np.abs(a - full).max() <= step / 2 + 1e-5, name


def test_extract_features_h2d_wires(feature_tree):
    """The host-resampled wires equal JAX's within 1e-4 (the same native
    matrices), and keep the JAX test's gates against the i16_src run."""
    ref = _features(feature_tree, 'port', wire='f32', stages=2)
    for h2d in ('i16_tgt', 'mulaw8_tgt'):
        got = _features(feature_tree, 'port', wire='f32', h2d=h2d)
        theirs = _features(feature_tree, 'jax', wire='f32', h2d=h2d)
        for name in NAMES:
            np.testing.assert_allclose(got[name], theirs[name], atol=1e-4, err_msg=name)
            t = min(ref[name].shape[1], got[name].shape[1]) - 2
            assert abs(ref[name].shape[1] - got[name].shape[1]) <= 1
            delta = np.abs(got[name][:, :t] - ref[name][:, :t])
            if h2d == 'i16_tgt':
                assert delta.max() < 0.05, (name, delta.max())
            else:
                assert delta.max() < 0.5 and delta.mean() < 0.02, (name, delta.max())
    with pytest.raises(ValueError, match='wire'):
        Processor.extract_features(str(feature_tree / 'in'), str(feature_tree / 'x'),
                                   wire='f16', device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            Processor.extract_features(str(feature_tree / 'in'), str(feature_tree / 'x'))


def test_extract_features_raises_over_several_ranks(feature_tree, monkeypatch):
    """JAX shards the corpus per host, and so does the port per rank (over
    2 gloo ranks in tests/test_torch_parallel.py). Over several ranks on
    'cuda' with no card it raises, and starts no process group: no rank
    falls back to the CPU."""
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('RANK', '1')
    monkeypatch.setenv('LOCAL_RANK', '1')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Processor.extract_features(str(feature_tree / 'in'), str(feature_tree / 'x'))
    assert not torch.distributed.is_initialized()


def test_extract_features_takes_its_torchrun_shard_without_a_group(feature_tree, monkeypatch,
                                                                    tmp_path):
    """Under torchrun's ``RANK`` / ``WORLD_SIZE`` with no process group
    running, a rank extracts its strided shard of the sorted wav list
    (``process_shard_indices``), counts only those, and starts no group."""
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('RANK', '1')
    monkeypatch.setenv('LOCAL_RANK', '1')
    stats = Processor.extract_features(str(feature_tree / 'in'), str(tmp_path), batch_size=2,
                                       pad_seconds=PAD, device='cpu')
    paths = sorted(glob.glob(os.path.join(str(feature_tree / 'in'), '**', '*.wav'),
                             recursive=True))
    mine = sorted({os.path.basename(paths[i])[:-len('.wav')]
                   for i in process_shard_indices(len(paths), 1, 2)} & set(NAMES))
    assert 0 < len(mine) < len(NAMES)
    assert sorted(os.listdir(tmp_path)) == [n + '.mel.npy' for n in mine]
    assert stats['utterances'] == len(mine)
    assert not torch.distributed.is_initialized()
