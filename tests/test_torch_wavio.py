"""The port's pure-Python WAV I/O against the JAX package's: each reads the
other's files to equal arrays (float32, int16, multichannel, 8- / 24- /
32-bit PCM, float64), writes the same bytes, and the header-only probes
(``read_wav_info``, ``get_wav_duration``) agree, -1 on a file cut short."""

import struct

import numpy as np
import pytest

from pytorch_sound_tpu.utils import sound as jax_sound
from pytorch_sound_tpu.utils import wavio as jax_wavio
from pytorch_sound_tpu_torch.utils import sound, wavio

SR = 22050


def _signal(channels, n=3001, seed=0):
    rng = np.random.default_rng(seed + channels)
    x = (rng.standard_normal((channels, n)) * 0.3).astype(np.float32)
    return x[0] if channels == 1 else x


@pytest.mark.parametrize('dtype', ['float32', 'int16'])
@pytest.mark.parametrize('channels', [1, 2, 3])
def test_each_reads_the_others_files(tmp_path, dtype, channels):
    x = _signal(channels)
    ours, theirs = str(tmp_path / 'port.wav'), str(tmp_path / 'jax.wav')
    wavio.write_wav(ours, x, SR, dtype=dtype)
    jax_wavio.write_wav(theirs, x, SR, dtype=dtype)
    with open(ours, 'rb') as a, open(theirs, 'rb') as b:
        assert a.read() == b.read()
    for path in (ours, theirs):
        got, ref = wavio.read_wav(path), jax_wavio.read_wav(path)
        assert got[1] == ref[1] == SR
        assert got[0].dtype == ref[0].dtype == np.float32 and np.array_equal(got[0], ref[0])
        assert got[0].shape == ((channels, 3001) if channels > 1 else (3001,))
        # mono: the JAX package's load_wav takes its native decoder, which
        # mixes in float64 (its pure-Python mean in float32 is 1 ulp off at 3
        # channels); the port mixes as the native decoder does
        got, ref = wavio.load_wav(path), jax_wavio.load_wav(path)
        assert got[1] == ref[1] and np.array_equal(got[0], ref[0]) and got[0].ndim == 1
        assert wavio.read_wav_info(path) == jax_wavio.read_wav_info(path) == (
            SR, 3001, channels, 32 if dtype == 'float32' else 16)
        assert sound.get_wav_duration(path) == jax_sound.get_wav_duration(path) == 3001 / SR
    if channels > 1:
        stereo, _ = wavio.load_wav(ours, mono=False)
        assert stereo.shape == (channels, 3001)


def _raw_wav(path, fmt_tag, bits, channels, body, extensible=False):
    block = channels * bits // 8
    fmt = struct.pack('<HHIIHH', 0xFFFE if extensible else fmt_tag, channels, SR,
                      SR * block, block, bits)
    if extensible:
        fmt += struct.pack('<HHI', 22, bits, 0) + struct.pack('<H', fmt_tag) + bytes(14)
    with open(path, 'wb') as f:
        f.write(b'RIFF' + struct.pack('<I', 4 + 8 + len(fmt) + 8 + len(body)) + b'WAVE')
        f.write(b'LIST' + struct.pack('<I', 3) + b'abc\x00')      # odd chunk, padded
        f.write(b'fmt ' + struct.pack('<I', len(fmt)) + fmt)
        f.write(b'data' + struct.pack('<I', len(body)) + body)


@pytest.mark.parametrize('kind', ['pcm8', 'pcm24', 'pcm32', 'float64', 'extensible16'])
def test_other_formats_read_alike(tmp_path, kind):
    rng = np.random.default_rng(3)
    path = str(tmp_path / (kind + '.wav'))
    n = 999
    if kind == 'pcm8':
        _raw_wav(path, 1, 8, 1, rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    elif kind == 'pcm24':
        _raw_wav(path, 1, 24, 2, rng.integers(0, 256, 2 * 3 * n, dtype=np.uint8).tobytes())
    elif kind == 'pcm32':
        _raw_wav(path, 1, 32, 1, rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32).tobytes())
    elif kind == 'float64':
        _raw_wav(path, 3, 64, 1, rng.standard_normal(n).tobytes())
    else:
        _raw_wav(path, 1, 16, 1, rng.integers(-2 ** 15, 2 ** 15, n, dtype=np.int16).tobytes(),
                 extensible=True)
    got, ref = wavio.read_wav(path), jax_wavio.read_wav(path)
    assert got[1] == ref[1] and np.array_equal(got[0], ref[0]) and got[0].dtype == np.float32
    assert wavio.read_wav_info(path) == jax_wavio.read_wav_info(path)
    assert np.array_equal(wavio.load_wav(path)[0], jax_wavio.load_wav(path)[0])


def test_probes_fail_alike(tmp_path):
    """A file cut inside its fmt chunk, a foreign file and a missing one:
    -1 from both duration probes; a cut data chunk reads what is there."""
    full = str(tmp_path / 'full.wav')
    wavio.write_wav(full, _signal(1), SR, dtype='int16')
    data = open(full, 'rb').read()
    cut, short, foreign = (str(tmp_path / n) for n in ('cut.wav', 'short.wav', 'x.wav'))
    open(cut, 'wb').write(data[:30])
    open(short, 'wb').write(data[:1000])
    open(foreign, 'wb').write(b'not a wave file at all')
    for path in (cut, foreign, str(tmp_path / 'missing.wav')):
        assert sound.get_wav_duration(path) == jax_sound.get_wav_duration(path) == -1
    assert sound.get_wav_duration(short) == jax_sound.get_wav_duration(short) == 3001 / SR
    got, ref = wavio.read_wav(short), jax_wavio.read_wav(short)
    assert np.array_equal(got[0], ref[0]) and len(got[0]) == (1000 - 44) // 2
    with pytest.raises(ValueError, match='RIFF'):
        wavio.read_wav(foreign)


def test_load_wav_raises_on_another_rate(tmp_path):
    """No resampler yet: asking for another rate raises, with no fallback."""
    path = str(tmp_path / 'a.wav')
    wavio.write_wav(path, _signal(1), SR)
    assert wavio.load_wav(path, sr=SR)[1] == SR
    with pytest.raises(NotImplementedError, match='resampl'):
        wavio.load_wav(path, sr=16000)
    with pytest.raises(ValueError, match='dtype'):
        wavio.write_wav(path, _signal(1), SR, dtype='int8')
