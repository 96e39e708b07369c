"""Build and load the package's CUDA kernels.

All ``csrc/*.cu`` sources are compiled by ``nvcc`` (one process per source,
in parallel) and linked into one shared library with a plain C interface, on
first use, into ``csrc/build/`` (listed in ``.gitignore``) under a name keyed
by a hash of the sources and flags, and loaded with ``ctypes``. Nothing here runs at import: the CPU test suite
imports every module on a machine without ``nvcc``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', '..', 'csrc')
BUILD_DIR = os.path.join(CSRC, 'build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)

# argtypes of every C entry point (see the matching csrc/*.cu)
SIGNATURES = {
    'gen_stage_forward': [
        _P, _P, _I, _I, _I, _I, _I,         # x, out, n, c, t_in, u, k_up
        _P, _P,                             # up weight, up bias
        _I, _PI, _PI, _PI, _PP, _PP,        # n_blocks, rounds, k, d, w, b
        _P, _P, _I,                         # post weight, post bias, post_k
        _P, _P, _I, _I,                     # pre weight, pre bias, c_mel, pre_k
        _I, _P],                            # mode, stream
    'resblock_stage_forward': [
        _P, _P, _I, _I, _I,                 # x, out, n, c, t
        _I, _PI, _PI, _PI, _PP, _PP,        # n_blocks, rounds, k, d, w, b
        _I, _P],                            # mode, stream
    'logmel_forward': [
        _P, _P, _I, _I, _I, _I, _I, _I,     # wav, out, b, t, pad, n_fft, hop, frames
        _P, _P, _P, _I,                     # window, twiddles, split, f_used
        _P, _P, _I,                         # mel, bands, n_mels
        _F, _F, _F, _F, _F,                 # power_eps, log_floor, log_offset, lo, hi
        _I, _P],                            # route (1: the direct DFT), stream
    'logmel_backward': [
        _P, _P, _P, _P,                     # wav, grad, dframes, dwav
        _I, _I, _I, _I, _I, _I,             # b, t, pad, n_fft, hop, frames
        _P, _P, _P, _I,                     # window, twiddles, split, f_used
        _P, _P, _P, _I,                     # mel, bands, bin_mels, n_mels
        _F, _F, _I, _P],                    # power_eps, log_floor, route, stream
    'grouped_conv_forward': [
        _P, _P, _P, _P,                     # x, w, bias, y
        _I, _I, _I, _I, _I,                 # n, cin, t_in, cout, t_out
        _I, _I, _I, _I, _I,                 # k, stride, pad, dilation, groups
        _I, _F, _I, _I, _P],                # has_slope, slope, precision, bf16, stream
    'grouped_conv_input_grad': [
        _P, _P, _P, _P,                     # gy, w, bias, dx
        _I, _I, _I, _I, _I,                 # n, cin, t_in, cout, t_out
        _I, _I, _I, _I, _I,                 # k, stride, pad, dilation, groups
        _I, _F, _I, _I, _P],                # has_slope, slope, precision, bf16, stream
    'grouped_conv_weight_grad': [
        _P, _P, _P, _P,                     # x, gy, dw, scratch
        _I, _I, _I, _I, _I,                 # n, cin, t_in, cout, t_out
        _I, _I, _I, _I, _I,                 # k, stride, pad, dilation, groups
        _I, _I, _I, _P],                    # splits, precision, bf16, stream
    'flash_attention_forward': [
        _P, _P, _P, _P, _P, _P,             # q, k, v, key_valid, o, lse
        _I, _I, _I, _I, _I, _F, _P],        # bh, heads, tq, tk, d, scale, stream
    'flash_attention_dkv': [
        _P, _P, _P, _P, _P, _P, _P,         # q, k, v, key_valid, dout, lse, di
        _P, _P,                             # dk, dv
        _I, _I, _I, _I, _I, _F, _P],        # bh, heads, tq, tk, d, scale, stream
    'mma_rate': [_P, _I, _I, _I, _P],     # out, blocks, threads, iters, stream
    'flash_attention_dq': [
        _P, _P, _P, _P, _P, _P, _P,         # q, k, v, key_valid, dout, lse, di
        _P,                                 # dq
        _I, _I, _I, _I, _I, _F, _P],        # bh, heads, tq, tk, d, scale, stream
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(('.cu', '.cuh')))


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, 'bin', 'nvcc')):
        return os.path.join(CUDA_HOME, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels are built with the '
                       'CUDA toolkit on first use')


def library_path() -> str:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, 'libpstt_%s.so' % digest.hexdigest()[:16])


def _run(procs):
    """Wait for every (cmd, Popen); raise on the first that failed."""
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = 'nvcc failed (%d):\n%s\n%s' % (proc.returncode, ' '.join(cmd), err)
    if failed:
        raise RuntimeError(failed)


def build() -> str:
    """Compile the kernels unless a library for these sources exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = '%s.%d' % (out, os.getpid())
    nvcc = _nvcc()
    objs, procs = [], []
    for i, src in enumerate(s for s in sources() if s.endswith('.cu')):
        obj = '%s.%d.o' % (tag, i)
        cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', obj, src]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    try:
        _run(procs)
        tmp = tag + '.tmp'
        cmd = [nvcc, '-shared', *NVCC_FLAGS, '-o', tmp, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)      # atomic: concurrent builders race harmlessly
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError('CUDA kernel %s failed to launch: cudaError %d'
                           % (name, code))


def int_array(values):
    return (ctypes.c_int * len(values))(*values)


def ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
