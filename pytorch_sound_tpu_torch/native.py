"""ctypes bindings of the native audio runtime (``csrc/tpusound.cc``): the
port's copy of ``pytorch_sound_tpu/native.py``.

The library is host code, built with ``g++ -O2 -fPIC -std=c++17 -Wall -shared
-lpthread`` at first use into ``csrc/build/`` (listed in ``.gitignore``) under
a name keyed by a hash of the source and the flags. The build writes a
temporary file and renames it into place under a file lock, so processes that
start together (test workers) neither compile twice nor load a half-written
library. There is no fallback: where the library cannot be built, every entry
point raises with the compiler's message (the JAX package returns ``None``
and its callers take other code, for ``wavio.resample`` another filter).

The batch loaders release the GIL (a pthread pool in C++), so decode and
resample scale with the cores from one Python thread.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc', 'tpusound.cc')
BUILD_DIR = os.path.join(os.path.dirname(SOURCE), 'build')
CXX_FLAGS = ['-O2', '-fPIC', '-std=c++17', '-Wall', '-shared']
LD_FLAGS = ['-lpthread']

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    digest = hashlib.sha256(' '.join(CXX_FLAGS + LD_FLAGS).encode())
    with open(SOURCE, 'rb') as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, 'libtpusound_%s.so' % digest.hexdigest()[:16])


def build() -> str:
    """Compile the library unless one for this source exists; raises
    ``RuntimeError`` with the compiler's output when it cannot."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which('g++') or shutil.which('c++')
    if not cxx:
        raise RuntimeError('the native audio runtime needs a C++ compiler (g++), '
                           'and none was found')
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, 'tpusound.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):          # another process built it meanwhile
            tmp = '%s.%d.tmp' % (out, os.getpid())
            cmd = [cxx, *CXX_FLAGS, SOURCE, '-o', tmp, *LD_FLAGS]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError('building the native audio runtime failed (%d):\n%s\n%s'
                                   % (proc.returncode, ' '.join(cmd), proc.stderr))
            os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32 = np.ctypeslib.ndpointer(np.float32)
    lib.ts_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ts_wav_info.restype = ctypes.c_int
    lib.ts_read_wav.argtypes = [ctypes.c_char_p, f32, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int)]
    lib.ts_read_wav.restype = ctypes.c_int64
    lib.ts_write_wav.argtypes = [ctypes.c_char_p, f32, ctypes.c_int64, ctypes.c_int]
    lib.ts_write_wav.restype = ctypes.c_int
    lib.ts_resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.ts_resample_out_len.restype = ctypes.c_int64
    lib.ts_resample.argtypes = [f32, ctypes.c_int64, f32, ctypes.c_int, ctypes.c_int]
    lib.ts_resample.restype = ctypes.c_int64
    lib.ts_rms_normalize.argtypes = [f32, ctypes.c_int64, ctypes.c_float]
    lib.ts_rms_normalize.restype = None
    lib.ts_mulaw_encode.argtypes = [f32, ctypes.c_int64, ctypes.c_int,
                                    np.ctypeslib.ndpointer(np.int32)]
    lib.ts_mulaw_encode.restype = None
    lib.ts_mulaw_decode.argtypes = [np.ctypeslib.ndpointer(np.int32), ctypes.c_int64,
                                    ctypes.c_int, f32]
    lib.ts_mulaw_decode.restype = None
    lib.ts_batch_load.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.ts_batch_load.restype = ctypes.c_int
    lib.ts_batch_load_i16.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, np.ctypeslib.ndpointer(np.int16),
        ctypes.c_int64, np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int32),
        ctypes.c_int]
    lib.ts_batch_load_i16.restype = ctypes.c_int
    lib.ts_batch_load_wire.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, np.ctypeslib.ndpointer(np.int64),
        ctypes.c_int]
    lib.ts_batch_load_wire.restype = ctypes.c_int
    return lib


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(8, os.cpu_count() or 1)


def _c_paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def wav_info(path: str) -> Tuple[int, int, int, int]:
    """(sample_rate, n_frames, channels, bits) from the header alone."""
    sr, frames = ctypes.c_int(), ctypes.c_int64()
    ch, bits = ctypes.c_int(), ctypes.c_int()
    rc = load_library().ts_wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(frames),
                                    ctypes.byref(ch), ctypes.byref(bits))
    if rc != 0:
        raise IOError('ts_wav_info({}) failed rc={}'.format(path, rc))
    return sr.value, frames.value, ch.value, bits.value


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode to mono float32 (channels summed in float64, over the count)."""
    _, frames, _, _ = wav_info(path)
    out = np.empty(frames, dtype=np.float32)
    got_sr = ctypes.c_int()
    n = load_library().ts_read_wav(path.encode(), out, frames, ctypes.byref(got_sr))
    if n < 0:
        raise IOError('ts_read_wav({}) failed rc={}'.format(path, n))
    return out[:n], got_sr.value


def write_wav(path: str, samples: np.ndarray, sr: int):
    """Mono float32 samples as an IEEE-float WAV."""
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    rc = load_library().ts_write_wav(path.encode(), samples, len(samples), sr)
    if rc != 0:
        raise IOError('ts_write_wav({}) failed rc={}'.format(path, rc))


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Kaiser(8.6) polyphase resample, 24 taps per phase, of a 1-D signal."""
    lib = load_library()
    if orig_sr == target_sr:
        return np.asarray(wav, dtype=np.float32)
    g = int(np.gcd(orig_sr, target_sr))
    up, down = target_sr // g, orig_sr // g
    wav = np.ascontiguousarray(wav, dtype=np.float32)
    out = np.empty(lib.ts_resample_out_len(len(wav), up, down), dtype=np.float32)
    n = lib.ts_resample(wav, len(wav), out, up, down)
    return out[:n]


def rms_normalize(wav: np.ndarray, target_db: float = -23.0) -> np.ndarray:
    out = np.ascontiguousarray(wav, dtype=np.float32).copy()
    load_library().ts_rms_normalize(out, len(out), target_db)
    return out


def mulaw_encode(wav: np.ndarray, bins: int = 256) -> np.ndarray:
    wav = np.ascontiguousarray(wav, dtype=np.float32)
    out = np.empty(len(wav), dtype=np.int32)
    load_library().ts_mulaw_encode(wav, len(wav), bins, out)
    return out


def mulaw_decode(q: np.ndarray, bins: int = 256) -> np.ndarray:
    q = np.ascontiguousarray(q, dtype=np.int32)
    out = np.empty(len(q), dtype=np.float32)
    load_library().ts_mulaw_decode(q, len(q), bins, out)
    return out


def batch_load(paths: List[str], target_sr: int = 0, norm_db: float = -23.0,
               normalize: bool = False, max_seconds: float = 30.0,
               n_threads: int = 0) -> List[Optional[np.ndarray]]:
    """Decode (+ resample + normalize) many wav files in parallel, GIL-free:
    one float32 array per path, None where a file failed."""
    lib = load_library()
    n = len(paths)
    if n == 0:
        return []
    cap = int(max_seconds * (target_sr if target_sr > 0 else 48000)) + 1024
    bufs = [np.empty(cap, dtype=np.float32) for _ in range(n)]
    c_outs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in bufs])
    c_caps = (ctypes.c_int64 * n)(*([cap] * n))
    c_lens = (ctypes.c_int64 * n)()
    lib.ts_batch_load(_c_paths(paths), n, target_sr, norm_db, int(normalize),
                      c_outs, c_caps, c_lens, _threads(n_threads))
    return [bufs[i][:c_lens[i]].copy() if c_lens[i] >= 0 else None for i in range(n)]


def batch_load_wire(paths: List[str], target_sr: int, pad_len: int, mode: str = 'i16',
                    tail_ext: int = 0, n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Decode -> resample to ``target_sr`` -> reflect-tail -> quantize, in
    parallel, into the rows of one zero-padded matrix: the target-rate
    host -> device wire of ``extract_features``.

    ``mode``: 'i16' (int16 rows) or 'mulaw8' (mu-law-256 uint8 rows, as
    ``ts_mulaw_encode``; padding holds code 128). ``tail_ext``: mirror up to
    that many trailing samples into the zero tail. Returns (matrix, lens),
    lens[i] < 0 where a file failed (its row is zero)."""
    if mode not in ('i16', 'mulaw8'):
        raise ValueError("mode is 'i16' or 'mulaw8', got %r" % (mode,))
    lib = load_library()
    n = len(paths)
    out = np.zeros((max(n, 1), pad_len), dtype=np.uint8 if mode == 'mulaw8' else np.int16)
    lens = np.zeros(max(n, 1), dtype=np.int64)
    if n == 0:
        return out[:0], lens[:0]
    lib.ts_batch_load_wire(_c_paths(paths), n, target_sr, out.ctypes.data_as(ctypes.c_void_p),
                           pad_len, int(mode == 'mulaw8'), tail_ext, lens,
                           _threads(n_threads))
    return out, lens


def batch_load_i16(paths: List[str], pad_len: int, n_threads: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode many wav files in parallel into one contiguous (n, pad_len)
    int16 matrix (zero-padded rows): the source-rate host -> device wire.
    PCM16 mono files stream from disk into their row; other formats decode
    through float32 and are quantized with clamping.

    Returns (matrix, lens (n,) int64 with < 0 where a file failed, source
    rates (n,) int32)."""
    lib = load_library()
    n = len(paths)
    out = np.zeros((max(n, 1), pad_len), dtype=np.int16)
    lens = np.zeros(max(n, 1), dtype=np.int64)
    srs = np.zeros(max(n, 1), dtype=np.int32)
    if n == 0:
        return out[:0], lens[:0], srs[:0]
    lib.ts_batch_load_i16(_c_paths(paths), n, out, pad_len, lens, srs, _threads(n_threads))
    return out, lens, srs
