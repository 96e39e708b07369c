"""The port's host utilities against the JAX package's on the CPU: the
calculate, f0, MIDI and pre-emphasis cases of ``tests/test_utils.py`` on the
port, each also held to the JAX function on the same input (the numpy code is
a copy: f0, pre-emphasis, the low-pass and the piano roll equal bit for bit;
``calculate`` on numpy within 1e-12 and on tensors within the float32
round-off), the iteration helpers, the dataset's MIDI column, and the
Valenti command."""

import os
import struct

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.data.dataset import SpeechDataset as JaxSpeechDataset  # noqa: E402
from pytorch_sound_tpu.data.meta import MetaType as JaxMetaType  # noqa: E402
from pytorch_sound_tpu.utils import calculate as jax_calculate  # noqa: E402
from pytorch_sound_tpu.utils import iterer as jax_iterer  # noqa: E402
from pytorch_sound_tpu.utils import sound as jax_sound  # noqa: E402
from pytorch_sound_tpu_torch.data.dataset import SpeechDataset  # noqa: E402
from pytorch_sound_tpu_torch.data.meta import MetaTable, MetaType, read_table_json  # noqa: E402
from pytorch_sound_tpu_torch.data.meta.valenti import ValentiMeta, get_datasets  # noqa: E402
from pytorch_sound_tpu_torch.scripts.preprocess import Processor  # noqa: E402
from pytorch_sound_tpu_torch.utils import calculate, iterer, sound  # noqa: E402
from pytorch_sound_tpu_torch.utils.wavio import write_wav  # noqa: E402

SR, HOP = 22050, 256


def test_db2log_matches_formula_and_jax():
    assert np.isclose(calculate.db2log(-50), np.log(10 ** (-5.0)))
    assert np.isclose(calculate.db2log(30), np.log(10 ** 3.0))
    db = np.linspace(-80, 40, 13)
    np.testing.assert_array_equal(calculate.db2log(db), jax_calculate.db2log(db))
    out = calculate.db2log(torch.from_numpy(db.astype(np.float32)))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_calculate.db2log(
        jnp.asarray(db, jnp.float32))), rtol=1e-6)


@pytest.mark.parametrize('kind', ['numpy', 'tensor'])
def test_norm_unnorm_mel_roundtrip_and_jax(rng, kind):
    mel_min, mel_max = calculate.db2log(-50), calculate.db2log(30)
    x = rng.uniform(mel_min - 1, mel_max + 1, size=(4, 80, 10)).astype(np.float32)
    if kind == 'numpy':
        normed = calculate.norm_mel(x)
        np.testing.assert_allclose(normed, jax_calculate.norm_mel(x), atol=1e-12)
        back = calculate.unnorm_mel(normed)
        np.testing.assert_allclose(back, jax_calculate.unnorm_mel(normed), atol=1e-12)
    else:
        normed = calculate.norm_mel(torch.from_numpy(x))
        assert isinstance(normed, torch.Tensor) and normed.dtype == torch.float32
        np.testing.assert_allclose(normed.numpy(), np.asarray(jax_calculate.norm_mel(
            jnp.asarray(x))), atol=1e-6)
        back = calculate.unnorm_mel(normed).numpy()
        normed = normed.numpy()
    assert normed.min() >= -1 - 1e-6 and normed.max() <= 1 + 1e-6
    inside = (x >= mel_min) & (x <= mel_max)
    np.testing.assert_allclose(back[inside], x[inside], rtol=1e-5, atol=1e-5)


def test_volume_norm_log_numpy_and_tensor(rng):
    x = rng.standard_normal(1000).astype(np.float32)
    y = calculate.volume_norm_log(x, target_db=-11.5)
    assert np.isclose(np.std(y), 10 ** (-1.15), rtol=1e-4)
    np.testing.assert_array_equal(y, jax_calculate.volume_norm_log(x, target_db=-11.5))
    yt = calculate.volume_norm_log_torch(torch.from_numpy(x), target_db=-11.5).numpy()
    np.testing.assert_allclose(yt, np.asarray(jax_calculate.volume_norm_log_torch(
        jnp.asarray(x), target_db=-11.5)), rtol=1e-5)


@pytest.mark.parametrize('geometry', [(3, 1, 1), (5, 2, 1), (41, 4, 1), (3, 1, 5), (7, 3, 2)])
def test_conv_same_padding(geometry):
    assert calculate.conv_same_padding(*geometry) == jax_calculate.conv_same_padding(*geometry)


def test_iterer():
    assert iterer.single(3) == jax_iterer.single(3) == (3,)
    assert iterer.double('ab') == ('ab', 'ab')
    assert iterer.double([1, 2]) == [1, 2]
    it = iterer.repeat([1, 2])
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]


def test_preemphasis_roundtrip_and_jax(sine_wav):
    y = sound.preemphasis(sine_wav)
    z = sound.inv_preemphasis(y)
    np.testing.assert_allclose(z, sine_wav, atol=1e-4)
    np.testing.assert_array_equal(y, jax_sound.preemphasis(sine_wav))
    np.testing.assert_array_equal(z, jax_sound.inv_preemphasis(y))
    np.testing.assert_array_equal(sound.lowpass(sine_wav, 1000), jax_sound.lowpass(sine_wav, 1000))


def _tone_cases():
    """The signals of tests/test_utils.py's f0 cases, with the JAX tests'
    own gates: stationary tones, a 100 -> 400 Hz glissando, noise, silence,
    a harmonic complex."""
    t = np.arange(int(SR * 0.6)) / SR
    n = SR
    tt = np.arange(n) / SR
    f_inst = 100.0 * (4.0 ** tt)
    return {
        'tone_%g' % f: np.sin(2 * np.pi * f * t).astype(np.float32)
        for f in (82.4, 110.0, 220.0, 329.6, 440.0)
    } | {
        'glissando': np.sin(2 * np.pi * np.cumsum(f_inst) / SR).astype(np.float32),
        'noise': np.random.default_rng(0).standard_normal(SR // 2).astype(np.float32),
        'silence': np.zeros(SR // 2, dtype=np.float32),
        'harmonic': sum((0.6 ** k) * np.sin(2 * np.pi * 150.0 * (k + 1) * t[:SR // 2])
                        for k in range(5)).astype(np.float32),
    }


@pytest.mark.parametrize('name', sorted(_tone_cases()))
def test_get_f0_is_jax_and_meets_its_gates(name):
    """The YIN tracker equals JAX's bit for bit and passes the JAX tests'
    accuracy gates (tests/test_utils.py::test_get_f0_*)."""
    wav = _tone_cases()[name]
    f0 = sound.get_f0(wav, hop_length=HOP, sr=SR)
    np.testing.assert_array_equal(f0, jax_sound.get_f0(wav, hop_length=HOP, sr=SR))
    assert f0.dtype == np.float32
    if name.startswith('tone_'):
        freq = float(name[5:])
        voiced = f0[f0 > 0]
        assert len(voiced) > 0.9 * len(f0)
        rel = np.abs(voiced - freq) / freq
        assert np.median(rel) < 0.005 and rel.max() < 0.01
    elif name == 'glissando':
        centers = np.arange(len(f0)) * HOP
        expected = 100.0 * (4.0 ** (np.minimum(centers, SR - 1) / SR))
        sl = slice(3, len(f0) - 3)
        voiced = f0[sl] > 0
        assert voiced.mean() > 0.95
        rel = np.abs(f0[sl][voiced] - expected[sl][voiced]) / expected[sl][voiced]
        assert np.median(rel) < 0.01 and np.percentile(rel, 95) < 0.02
    elif name == 'noise':
        assert (f0 == 0).mean() > 0.7
    elif name == 'silence':
        assert (f0 == 0).all()
    else:
        voiced = f0[f0 > 0]
        assert len(voiced) > 0.9 * len(f0) and np.abs(np.median(voiced) - 150) / 150 < 0.01


def test_get_f0_dio_is_jax_and_meets_its_gates():
    """The dio-style tracker equals JAX's bit for bit on the JAX test's
    harmonic tone, sweep and noise, and passes that test's gates."""
    t = np.arange(SR) / SR
    harm = sum((1.0 / k) * np.sin(2 * np.pi * k * 220.0 * t) for k in range(1, 4))
    sweep = np.sin(2 * np.pi * np.cumsum(100.0 * (4.0 ** t)) / SR)
    noise = np.random.default_rng(0).standard_normal(SR)
    out = {}
    for name, wav in (('harm', harm), ('sweep', sweep), ('noise', noise)):
        wav = wav.astype(np.float32)
        out[name] = sound.get_f0_dio(wav, hop_length=HOP, sr=SR)
        np.testing.assert_array_equal(out[name], jax_sound.get_f0_dio(wav, hop_length=HOP,
                                                                      sr=SR))
    voiced = out['harm'][out['harm'] > 0]
    assert len(voiced) > 0.8 * len(out['harm'])
    assert np.abs(np.median(voiced) - 220.0) / 220.0 < 0.01
    f0 = out['sweep']
    centers = np.arange(len(f0)) * HOP / SR
    truth = 100.0 * (4.0 ** centers)
    sel = (f0 > 0) & (centers > 0.1) & (centers < 0.9)
    assert sel.sum() > 0.6 * ((centers > 0.1) & (centers < 0.9)).sum()
    assert np.median(np.abs(f0[sel] - truth[sel]) / truth[sel]) < 0.02
    assert (out['noise'] > 0).mean() < 0.2


def _midi_bytes(tracks, division=96, fmt=1):
    data = b'MThd' + struct.pack('>IHHH', 6, fmt, len(tracks), division)
    for track in tracks:
        data += b'MTrk' + struct.pack('>I', len(track)) + track
    return data


def test_midi_parse_roundtrip(tmp_path):
    """The JAX test's one-note file: a note on pitch 60 for one beat at 120
    bpm, 0.5 s at 100 frames a second."""
    track = (b'\x00' + bytes([0xFF, 0x51, 0x03]) + (500000).to_bytes(3, 'big')
             + b'\x00' + bytes([0x90, 60, 100]) + b'\x60' + bytes([0x80, 60, 0])
             + b'\x00' + bytes([0xFF, 0x2F, 0x00]))
    path = str(tmp_path / 't.mid')
    with open(path, 'wb') as f:
        f.write(_midi_bytes([track], fmt=0))
    mid = sound.parse_midi(path)
    assert len(mid.notes) == 1
    n = mid.notes[0]
    assert n.pitch == 60 and np.isclose(n.end - n.start, 0.5, atol=1e-6)
    roll = mid.get_piano_roll()
    assert roll.shape[0] == 128 and (roll[60] == 100).sum() >= 49


def test_midi_piano_roll_is_jax_exactly(tmp_path):
    """Two tracks, a tempo change, running status, a note-on of velocity 0
    as note-off, a sysex and a zero-length note: the port's notes and roll
    are JAX's exactly, at two frame rates; a file that is not MIDI raises."""
    tempo = (b'\x00' + bytes([0xFF, 0x51, 0x03]) + (500000).to_bytes(3, 'big')
             + b'\x81\x40' + bytes([0xFF, 0x51, 0x03]) + (300000).to_bytes(3, 'big')
             + b'\x00' + bytes([0xFF, 0x2F, 0x00]))
    notes = (b'\x00' + bytes([0x90, 60, 80]) + b'\x10' + bytes([64, 70])     # running status
             + b'\x00' + bytes([0xF0, 0x02, 0x7E, 0xF7])                     # sysex
             + b'\x83\x00' + bytes([0x90, 60, 0]) + b'\x20' + bytes([0x80, 64, 0])
             + b'\x00' + bytes([0x91, 72, 100]) + b'\x00' + bytes([0x81, 72, 0])
             + b'\x05' + bytes([0xC0, 5]) + b'\x00' + bytes([0x92, 48, 55])
             + b'\x87\x40' + bytes([0x82, 48, 0]) + b'\x00' + bytes([0xFF, 0x2F, 0x00]))
    path = str(tmp_path / 'two.mid')
    with open(path, 'wb') as f:
        f.write(_midi_bytes([tempo, notes]))
    port, ref = sound.parse_midi(path), jax_sound.parse_midi(path)
    assert [tuple(n) for n in port.notes] == [tuple(n) for n in ref.notes]
    assert len(port.notes) == 3                 # the zero-length note is removed
    for fs in (100, 37):
        np.testing.assert_array_equal(port.get_piano_roll(fs), ref.get_piano_roll(fs))
    bad = str(tmp_path / 'bad.mid')
    with open(bad, 'wb') as f:
        f.write(b'RIFF0000')
    with pytest.raises(ValueError, match='error reading midi file'):
        sound.parse_midi(bad)


class _MidiMeta:
    """A meta of one MIDI column, for the dataset's MIDI branch."""
    sr = 22050

    def __init__(self, paths, midi_type):
        self.meta = MetaTable({'midi_filename': paths})
        self.iloc = self.meta.iloc
        self.process_columns = self.columns = [(midi_type, 'midi_filename')]

    def __len__(self):
        return len(self.meta)


def test_dataset_midi_column_is_jax(tmp_path):
    """``SpeechDataset`` loads a MIDI column as the (128, T) piano roll,
    as JAX's does."""
    track = (b'\x00' + bytes([0x90, 60, 100]) + b'\x83\x00' + bytes([0x80, 60, 0])
             + b'\x00' + bytes([0xFF, 0x2F, 0x00]))
    path = str(tmp_path / 'n.mid')
    with open(path, 'wb') as f:
        f.write(_midi_bytes([track]))
    (roll,) = SpeechDataset(_MidiMeta([path], MetaType.MIDI))[0]
    (ref,) = JaxSpeechDataset(_MidiMeta([path], JaxMetaType.MIDI))[0]
    assert roll.shape == (128, 201) and roll.dtype == np.float32   # 2 s at 100 frames a second
    np.testing.assert_array_equal(roll, ref)


def test_valenti_command(tmp_path):
    """``Processor.valenti`` on the VoiceBank layout: normalised wavs, the
    texts copied, a meta of noisy / clean pairs split by 'trainset'."""
    rng = np.random.default_rng(5)
    raw = tmp_path / 'raw'
    for phase, spk in (('trainset', 'p280'), ('validset', 'p281')):
        for kind in ('clean', 'noisy'):
            (raw / ('%s_%s_wav' % (phase, kind))).mkdir(parents=True)
        for u in range(3):
            key = '%s_%03d' % (spk, u)
            clean = (0.3 * np.sin(2 * np.pi * 220 * np.arange(SR * 2) / SR)).astype(np.float32)
            for kind, wav in (('clean', clean), ('noisy', clean + 0.05 * rng.standard_normal(
                    len(clean)).astype(np.float32))):
                write_wav(str(raw / ('%s_%s_wav' % (phase, kind)) / (key + '.wav')), wav, SR)
            (raw / ('%s_%s_wav' % (phase, 'clean')) / (key + '.txt')).write_text('hello %d.' % u)
    out = tmp_path / 'out'
    Processor.valenti(str(raw), str(out))
    meta_dir = str(out / 'meta')
    train, val = (read_table_json(os.path.join(meta_dir, f))
                  for f in ValentiMeta.frame_file_names[1:])
    assert len(train) == 3 and len(val) == 3
    assert all('trainset' in p for p in train['noise_filename'])
    assert all(os.path.exists(p) for p in train['clean_filename'])
    loader, _ = get_datasets(meta_dir, batch_size=2, num_workers=0, fix_len=4096)
    noisy, clean = next(iter(loader))[:2]
    assert noisy.shape == clean.shape == (2, 4096)
