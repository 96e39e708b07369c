"""WAV file I/O in pure Python: the port's copy of the pure-Python path of
``pytorch_sound_tpu/utils/wavio.py``.

PCM 8/16/24/32-bit and IEEE float32/64 in, float32 or int16 out, mono
mixdown and header-only queries. Files are read here, in Python;
:func:`resample` is the native runtime's Kaiser polyphase resampler
(:mod:`pytorch_sound_tpu_torch.native`, ``csrc/tpusound.cc``), which
:func:`load_wav` takes where the caller asks for a rate other than the
file's. It has no fallback: where the native library cannot be built, it
raises.
"""

import struct
from typing import Optional, Tuple

import numpy as np

from pytorch_sound_tpu_torch import native

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _iter_chunks(raw: bytes):
    """Yield (chunk_id, offset, size) for every RIFF chunk."""
    pos = 12
    n = len(raw)
    while pos + 8 <= n:
        cid = raw[pos:pos + 4]
        size = struct.unpack_from('<I', raw, pos + 4)[0]
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)   # chunks are word-aligned


def read_wav_info(path: str) -> Tuple[int, int, int, int]:
    """Header-only query: returns (sample_rate, n_frames, n_channels, bits)."""
    with open(path, 'rb') as f:
        head = f.read(12)
        if head[:4] != b'RIFF' or head[8:12] != b'WAVE':
            raise ValueError('{} is not a RIFF/WAVE file'.format(path))
        sr = channels = bits = 0
        block_align = 1
        n_frames = 0
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack('<I', hdr[4:])[0]
            if cid == b'fmt ':
                fmt = f.read(size)
                _, channels, sr, _, block_align, bits = struct.unpack_from('<HHIIHH', fmt, 0)
            elif cid == b'data':
                n_frames = size // max(block_align, 1)
                break
            else:
                f.seek(size + (size & 1), 1)
        return sr, n_frames, channels, bits


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file to float32 in [-1, 1]; returns (samples, sample_rate).

    Multi-channel audio is returned as (channels, T).
    """
    with open(path, 'rb') as f:
        raw = f.read()
    if raw[:4] != b'RIFF' or raw[8:12] != b'WAVE':
        raise ValueError('{} is not a RIFF/WAVE file'.format(path))

    fmt_tag = sr = channels = bits = None
    data_off = data_size = None
    for cid, off, size in _iter_chunks(raw):
        if cid == b'fmt ':
            fmt_tag, channels, sr, _, _, bits = struct.unpack_from('<HHIIHH', raw, off)
            if fmt_tag == _WAVE_FORMAT_EXTENSIBLE and size >= 40:
                fmt_tag = struct.unpack_from('<H', raw, off + 24)[0]
        elif cid == b'data':
            data_off, data_size = off, size
    if fmt_tag is None or data_off is None:
        raise ValueError('{}: missing fmt/data chunk'.format(path))
    data_size = min(data_size, len(raw) - data_off)
    body = raw[data_off:data_off + data_size]

    if fmt_tag == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(body, dtype=dtype).astype(np.float32)
    elif fmt_tag == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(body, dtype='<i2').astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(body, dtype='<i4').astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(body[:len(body) - len(body) % 3], dtype=np.uint8).reshape(-1, 3)
            x = ((b[:, 0].astype(np.int32))
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(body, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise NotImplementedError('PCM {} bit is not supported'.format(bits))
    else:
        raise NotImplementedError('WAV format tag {} is not supported'.format(fmt_tag))

    if channels and channels > 1:
        x = x[:len(x) - len(x) % channels].reshape(-1, channels).T
    return x, sr


def write_wav(path: str, samples: np.ndarray, sr: int, dtype: str = 'float32'):
    """Write mono/multi-channel float samples to a WAV file ('float32' or 'int16')."""
    samples = np.asarray(samples)
    channels = 1 if samples.ndim == 1 else samples.shape[0]
    if samples.ndim == 2:   # (channels, T) -> interleave
        samples = samples.T.reshape(-1)
    if dtype == 'float32':
        body = samples.astype('<f4').tobytes()
        fmt_tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    elif dtype == 'int16':
        body = (np.clip(samples, -1, 1) * 32767.0).astype('<i2').tobytes()
        fmt_tag, bits = _WAVE_FORMAT_PCM, 16
    else:
        raise ValueError('dtype must be float32 or int16')
    block_align = channels * bits // 8
    with open(path, 'wb') as f:
        f.write(b'RIFF' + struct.pack('<I', 36 + len(body)) + b'WAVE')
        f.write(b'fmt ' + struct.pack('<IHHIIHH', 16, fmt_tag, channels, sr,
                                      sr * block_align, block_align, bits))
        f.write(b'data' + struct.pack('<I', len(body)))
        f.write(body)


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase rational resampling of a 1-D signal (Kaiser beta 8.6, 24
    taps per phase) by the native library: the filter that
    ``ops.resample.resample_poly`` computes on tensors. The JAX package's
    ``wavio.resample`` takes scipy's ``resample_poly`` (another filter) where
    its library is missing; this one raises."""
    if orig_sr == target_sr:
        return wav
    return native.resample(np.asarray(wav, np.float32), int(orig_sr), int(target_sr))


def load_wav(path: str, sr: Optional[int] = None, mono: bool = True) -> Tuple[np.ndarray, int]:
    """librosa.load-style helper: read, mono-mix, resample to ``sr`` where
    it is given and differs from the file's rate; returns (samples, rate).
    The mixdown sums the channels in float64 and scales by 1 / channels, as
    the native decoder (``csrc/tpusound.cc``), which the JAX package's
    ``load_wav`` takes, does."""
    wav, orig_sr = read_wav(path)
    if mono and wav.ndim == 2:
        wav = (wav.astype(np.float64).sum(axis=0) * (1.0 / wav.shape[0])).astype(np.float32)
    if sr is not None and sr != orig_sr:
        wav = resample(wav, orig_sr, sr)
        orig_sr = sr
    return wav, orig_sr
