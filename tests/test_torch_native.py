"""The port's native audio runtime (``pytorch_sound_tpu_torch/native.py``,
its own build of ``csrc/tpusound.cc``): tests/test_native.py's cases and
tests/test_resample.py's int16 batch loader, and the port's library against
the JAX package's, bit for bit, on the resampler and the batch loaders. The
library is built here with g++; where it cannot be, these tests fail."""

import os
import struct

import numpy as np
import pytest

from pytorch_sound_tpu import native as jax_native
from pytorch_sound_tpu_torch import native
from pytorch_sound_tpu_torch.utils import wavio


@pytest.fixture(scope='module')
def wav_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = str(tmp_path_factory.mktemp('native') / 'a.wav')
    t = np.arange(22050 * 2) / 22050
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    wavio.write_wav(path, wav, 22050)
    return path, wav


def test_native_builds_from_the_ports_source():
    """The library is the port's own build, into csrc/build/, and loads."""
    assert native.library_path().startswith(native.BUILD_DIR)
    assert os.path.exists(native.build())
    assert native.load_library() is native.load_library()
    assert os.path.realpath(native.SOURCE) != os.path.realpath(
        os.path.join(os.path.dirname(jax_native.__file__), '..', 'csrc', 'tpusound.cc'))


def test_native_wav_info(wav_file):
    path, wav = wav_file
    assert native.wav_info(path) == (22050, len(wav), 1, 32) == jax_native.wav_info(path)
    with pytest.raises(IOError):
        native.wav_info(path + '.missing')


def test_native_read_matches_python(wav_file):
    path, _ = wav_file
    n_wav, sr = native.read_wav(path)
    p_wav, p_sr = wavio.read_wav(path)
    assert sr == p_sr
    np.testing.assert_allclose(n_wav, p_wav, atol=1e-7)


def test_native_write_roundtrip(tmp_path, wav_file):
    _, wav = wav_file
    out, ref = str(tmp_path / 'w.wav'), str(tmp_path / 'j.wav')
    native.write_wav(out, wav, 22050)
    jax_native.write_wav(ref, wav, 22050)
    assert open(out, 'rb').read() == open(ref, 'rb').read()
    back, sr = wavio.read_wav(out)
    assert sr == 22050
    np.testing.assert_allclose(back, wav, atol=1e-7)


def test_native_int16_decode(tmp_path):
    rng = np.random.default_rng(1)
    wav = (0.3 * rng.standard_normal(10000)).astype(np.float32).clip(-1, 1)
    path = str(tmp_path / 'i16.wav')
    wavio.write_wav(path, wav, 16000, dtype='int16')
    n_wav, _ = native.read_wav(path)
    np.testing.assert_allclose(n_wav, wavio.read_wav(path)[0], atol=1e-6)


@pytest.mark.parametrize('sr_in,sr_out', [(48000, 22050), (44100, 22050), (16000, 22050),
                                          (22050, 48000)])
def test_native_resample_quality(sr_in, sr_out):
    """A 1 kHz tone stays clean, and the port's library resamples it (and
    noise) to the JAX library's bits."""
    t = np.arange(sr_in) / sr_in
    sine = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    out = native.resample(sine, sr_in, sr_out)
    assert abs(len(out) - sr_out) <= 2
    t2 = np.arange(len(out)) / sr_out
    assert np.corrcoef(out[200:-200], np.sin(2 * np.pi * 1000 * t2)[200:-200])[0, 1] > 0.999
    noise = np.random.default_rng(sr_in).standard_normal(7777).astype(np.float32)
    for x in (sine, noise):
        assert np.array_equal(out if x is sine else native.resample(x, sr_in, sr_out),
                              jax_native.resample(x, sr_in, sr_out))


def test_native_rms_normalize():
    rng = np.random.default_rng(2)
    wav = (0.01 * rng.standard_normal(40000)).astype(np.float32)
    out = native.rms_normalize(wav, -23.0)
    assert abs(20 * np.log10(np.sqrt(np.mean(out ** 2))) + 23.0) < 0.1
    assert np.array_equal(out, jax_native.rms_normalize(wav, -23.0))


def test_native_mulaw_roundtrip():
    rng = np.random.default_rng(3)
    wav = np.tanh(rng.standard_normal(5000)).astype(np.float32)
    q = native.mulaw_encode(wav, 256)
    assert q.min() >= 0 and q.max() <= 255
    assert np.array_equal(q, jax_native.mulaw_encode(wav, 256))
    back = native.mulaw_decode(q, 256)
    assert np.abs(back - wav).max() < 0.04
    small = np.linspace(-0.01, 0.01, 100).astype(np.float32)
    assert len(np.unique(native.mulaw_encode(small, 256))) > 10


def test_native_batch_load(tmp_path):
    rng = np.random.default_rng(4)
    paths = []
    for i in range(6):
        p = str(tmp_path / ('b%d.wav' % i))
        wavio.write_wav(p, (0.2 * rng.standard_normal(48000)).astype(np.float32), 48000)
        paths.append(p)
    paths.append(str(tmp_path / 'missing.wav'))
    outs = native.batch_load(paths, target_sr=22050, normalize=True, n_threads=4)
    theirs = jax_native.batch_load(paths, target_sr=22050, normalize=True, n_threads=4)
    assert len(outs) == 7 and outs[-1] is None and theirs[-1] is None
    for o, r in zip(outs[:-1], theirs[:-1]):
        assert abs(len(o) - 22050) <= 2 and np.array_equal(o, r)
        assert abs(20 * np.log10(np.sqrt(np.mean(o ** 2))) + 23.0) < 1.0


def test_load_wav_uses_native_consistently(wav_file):
    path, _ = wav_file
    via_loader, sr = wavio.load_wav(path, sr=16000)
    assert sr == 16000 and abs(len(via_loader) - 16000 * 2) <= 2
    assert np.array_equal(via_loader, native.resample(native.read_wav(path)[0], 22050, 16000))


def _write_wav16(path, pcm16, sr, fmt_tag=1, extensible=False):
    """Hand-rolled 16-bit mono RIFF writer with a controllable wFormatTag."""
    data = pcm16.astype('<i2').tobytes()
    if extensible:
        fmt = struct.pack('<HHIIHHHHI', 0xFFFE, 1, sr, sr * 2, 2, 16, 22, 16,
                          fmt_tag) + b'\x00\x00\x00\x00\x10\x00\x80\x00' \
              b'\x00\xAA\x00\x38\x9B\x71'
    else:
        fmt = struct.pack('<HHIIHH', fmt_tag, 1, sr, sr * 2, 2, 16)
    with open(path, 'wb') as w:
        w.write(b'RIFF' + struct.pack('<I', 20 + len(fmt) + len(data)) + b'WAVE')
        w.write(b'fmt ' + struct.pack('<I', len(fmt)) + fmt)
        w.write(b'data' + struct.pack('<I', len(data)) + data)


def test_batch_load_i16_fast_path_checks_format_tag(tmp_path):
    """The PCM16-mono fast path fires only for true PCM (plain and
    extensible); a 16-bit non-PCM tag goes through the general decoder."""
    rng = np.random.default_rng(7)
    pcm = (rng.integers(-20000, 20000, 1000)).astype(np.int16)
    paths = [str(tmp_path / n) for n in ('plain.wav', 'ext.wav', 'nonpcm.wav')]
    _write_wav16(paths[0], pcm, 16000)
    _write_wav16(paths[1], pcm, 16000, extensible=True)
    _write_wav16(paths[2], pcm, 16000, fmt_tag=2)    # claims ADPCM
    mat, lens, srs = native.batch_load_i16(paths, 1200)
    assert list(srs) == [16000] * 3 and list(lens) == [1000] * 3
    for row in mat:
        np.testing.assert_array_equal(row[:1000], pcm)
    assert not mat[:, 1000:].any()


def test_batch_loaders_match_the_jax_library(tmp_path):
    """batch_load_i16 and batch_load_wire (i16 and mulaw8, with the reflect
    tail) give the JAX library's matrices, lengths and rates, bit for bit:
    int16, float32 and stereo sources, one longer than the pad, one missing
    and one that is no WAV."""
    rng = np.random.default_rng(5)
    paths = []
    for i, (n, dtype, ch) in enumerate(((48000, 'int16', 1), (48999, 'float32', 1),
                                        (50000, 'int16', 1), (30000, 'int16', 2))):
        p = str(tmp_path / ('%d.wav' % i))
        x = 0.1 * rng.standard_normal((ch, n) if ch > 1 else n)
        wavio.write_wav(p, x.astype(np.float32), 48000, dtype=dtype)
        paths.append(p)
    (tmp_path / 'junk.wav').write_bytes(b'junk')
    paths += [str(tmp_path / 'missing.wav'), str(tmp_path / 'junk.wav')]
    pad = 22050 + 512
    for got, ref in ((native.batch_load_i16(paths, 49000), jax_native.batch_load_i16(paths, 49000)),
                     *((native.batch_load_wire(paths, 22050, pad, mode=m, tail_ext=516),
                        jax_native.batch_load_wire(paths, 22050, pad, mode=m, tail_ext=516))
                       for m in ('i16', 'mulaw8'))):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (got[1][-2:] < 0).all() and (got[1][:-2] > 0).all()
    with pytest.raises(ValueError, match='mode'):
        native.batch_load_wire(paths, 22050, pad, mode='f32')


def test_batch_load_wire_matches_batch_load(tmp_path):
    """The one-pass wire loader is the f32 pipeline + quantization: i16
    within 1 LSB, mu-law-256 within the companding bound; the crop comes
    after the resample; the tail is mirrored."""
    rng = np.random.default_rng(5)
    paths = []
    for i, n in enumerate((48000, 48999, 50000)):   # last exceeds pad
        p = str(tmp_path / ('%d.wav' % i))
        wavio.write_wav(p, (0.1 * rng.standard_normal(n)).astype(np.float32), 48000,
                        dtype='int16')
        paths.append(p)
    pad = 22050 + 512
    m16, l16 = native.batch_load_wire(paths, 22050, pad, mode='i16', tail_ext=516)
    m8, l8 = native.batch_load_wire(paths, 22050, pad, mode='mulaw8', tail_ext=516)
    ref = native.batch_load(paths, target_sr=22050)
    assert m16.dtype == np.int16 and m8.dtype == np.uint8
    for i in range(3):
        n = min(len(ref[i]), pad)
        assert l16[i] == n and l8[i] == n
        assert np.abs(m16[i, :n].astype(np.float32) / 32768.0 - ref[i][:n]).max() \
            < 1.0 / 32768 + 1e-6
        dec = native.mulaw_decode(m8[i, :n].astype(np.int32))
        assert np.abs(dec - ref[i][:n]).max() < 0.02
        if pad - n > 4:
            got = m16[i, n:n + 3].astype(np.float32) / 32768.0
            assert np.abs(got - ref[i][n - 2:n - 5:-1]).max() < 1.0 / 32768 + 1e-6


def test_native_batch_load_i16_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    paths, refs = [], []
    for i, (sr, n) in enumerate([(48000, 5000), (22050, 3000)]):
        w = (0.2 * rng.standard_normal(n)).astype(np.float32)
        p = str(tmp_path / ('x%d.wav' % i))
        wavio.write_wav(p, w, sr, dtype='int16')   # PCM16 = memcpy fast path
        paths.append(p)
        refs.append((wavio.load_wav(p)[0], sr))
    mat, lens, srs = native.batch_load_i16(paths, 6000)
    assert mat.shape == (2, 6000) and mat.dtype == np.int16
    for i, (w, sr) in enumerate(refs):
        assert lens[i] == len(w) and srs[i] == sr
        np.testing.assert_allclose(mat[i, :lens[i]].astype(np.float32) / 32768.0, w, atol=1e-6)
        assert (mat[i, lens[i]:] == 0).all()


def test_build_failure_raises_with_the_compilers_words(tmp_path, monkeypatch):
    """A source the compiler refuses: the build raises with its message and
    leaves no library behind (no fallback)."""
    bad = tmp_path / 'tpusound.cc'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(native, 'SOURCE', str(bad))
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match='error'):
        native.build()
    assert not [f for f in os.listdir(tmp_path / 'build') if f.endswith('.so')]
