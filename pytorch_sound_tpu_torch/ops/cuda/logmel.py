"""Fused log-mel frontend: wrapper of the CUDA kernels ``csrc/logmel.cu``.

Counterpart of ``pytorch_sound_tpu/ops/pallas/logmel.py`` (``fused_log_mel``,
``fused_hifigan_mel``): reflect pad -> frames -> windowed DFT over the bins the
mel filterbank uses -> magnitude -> mel -> log -> clip, in one launch; the
spectrum never reaches device memory. The card kernel takes the JAX kernel's
geometry, ``win_length == n_fft`` and ``hop_length | n_fft``, on two paths
(:func:`fft_path` says which): an in-block mixed-radix fp64 FFT for every
n_fft whose FFT size (n_fft / 2 if even, n_fft if odd) is 7-smooth, from 2
to 4096 points (400 / 100 at 16 kHz, 128 ... 8192, 1000, 300, 6000, 375),
and a direct fp64 DFT over the used bins for the others (802, 22, 1102).

The wrapper dispatches on the tensor's device: on the CPU it runs the plain
version (:func:`pytorch_sound_tpu_torch.ops.mel.log_mel`), on a CUDA tensor it
launches the kernel or raises. :func:`fused_hifigan_mel_trainable` (K4) wraps
the same kernel in an autograd function for the training loss, with a
backward kernel on the same FFT.
"""

import functools
import inspect
from typing import NamedTuple, Optional

import numpy as np
import torch

from pytorch_sound_tpu_torch.ops import filters
from pytorch_sound_tpu_torch.ops import mel as mel_ops
from pytorch_sound_tpu_torch.ops.cuda import _build

SOURCE = 'pytorch_sound_tpu_torch/csrc/logmel.cu'
PRECISIONS = ('highest', 'bf16x3', 'default')     # the JAX kernel's modes


class FFTConstants(NamedTuple):
    """The kernels' host-made tables, on one device."""
    window: torch.Tensor      # (n_fft,) float64, the centered periodic Hann window
    twiddles: torch.Tensor    # FFT path: (P, 2) float64, W_P^e = exp(-2 pi i e / P), P the
                              # FFT's size (fft_size); direct path: (n_fft, 2),
                              # exp(-2 pi i j / n_fft)
    split: torch.Tensor       # (f_used, 2) float64, exp(-2 pi i k / n_fft)
    mel_w: torch.Tensor       # (n_mels, f_used) float32, the filterbank's used bins
    bands: torch.Tensor       # (n_mels, 2) int32, each mel's nonzero bins [k0, k1)
    bin_mels: torch.Tensor    # (f_used, 2) int32, the mels [m0, m1) weighting each bin


FFT_MAX_SIZE = 4096      # points of the in-block FFT, at most (kMaxFftSize)


def fft_size(n_fft: int) -> int:
    """Points of the kernels' FFT of an n_fft frame: n_fft / 2 for an even
    n_fft (two real samples packed into one complex point), n_fft for an
    odd one."""
    return n_fft // 2 if n_fft % 2 == 0 else n_fft


def fft_path(n_fft: int) -> bool:
    """Whether the kernels take ``n_fft`` on the FFT path (``fft_geometry``
    in ``csrc/logmel.cu``): its FFT size (:func:`fft_size`) is from 2 to
    4096 points and has no prime factor above 7. That is every even n_fft
    from 4 to 8192 whose half is 7-smooth and every odd 7-smooth n_fft from
    3 to 4095. Every other n_fft (a prime factor above 7 in the FFT size, as
    802, 22 and 1102 have; an odd n_fft above 4096; n_fft 1, 2 and above
    8192) takes the direct DFT."""
    p = fft_size(n_fft)
    if not 2 <= p <= FFT_MAX_SIZE:
        return False
    for r in (2, 3, 5, 7):
        while p % r == 0:
            p //= r
    return p == 1


def _kernel_geometry(n_fft: int, hop_length: int, win_length: int):
    """Raises ``ValueError`` unless n_fft == win_length and hop_length |
    n_fft: the geometry of the JAX kernel (``ops/pallas/logmel.py:181-182``),
    which the kernels take on one of their two paths."""
    if win_length != n_fft or hop_length < 1 or n_fft % hop_length:
        raise ValueError(
            'the log-mel kernel takes the geometry n_fft == win, hop | n_fft; got n_fft '
            '%d, hop %d, win %d' % (n_fft, hop_length, win_length))


def _ranges(nonzero: np.ndarray) -> np.ndarray:
    """(rows, 2) int32 [first, last + 1) of each row's nonzeros ([0, 0) if none)."""
    out = np.zeros((nonzero.shape[0], 2), dtype=np.int32)
    for i, row in enumerate(nonzero):
        idx = np.flatnonzero(row)
        if idx.size:
            out[i] = idx[0], idx[-1] + 1
    return out


def _complex_pairs(z: np.ndarray) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=-1)


@functools.lru_cache(maxsize=8)
def _constants(sample_rate: int, n_fft: int, win_length: int, n_mels: int,
               fmin: float, fmax: Optional[float], device: str,
               direct: bool = False) -> FFTConstants:
    """The kernels' tables for one geometry, on ``device``.

    f_used counts only the spectral bins the mel filterbank weights (372 of
    513 at fmax 8 kHz); higher bins have exactly-zero mel weight and are never
    formed. Window and twiddles are fp64 from numpy: the kernels call no
    sincos. The twiddles are the FFT's P-point table on the FFT path
    (:func:`fft_size`), the n_fft-point one on the direct path (``direct``,
    or an n_fft off the FFT path).
    """
    mel = filters.mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    nz = np.nonzero(np.any(mel != 0.0, axis=0))[0]
    f_used = int(nz[-1]) + 1 if nz.size else n_fft // 2 + 1
    m = n_fft if direct or not fft_path(n_fft) else fft_size(n_fft)
    mel_w = np.asarray(mel[:, :f_used], dtype=np.float32)
    arrays = (filters.pad_center(filters.hann_window(win_length), n_fft),
              _complex_pairs(np.exp(-2j * np.pi * np.arange(m) / m)),
              _complex_pairs(np.exp(-2j * np.pi * np.arange(f_used) / n_fft)),
              mel_w, _ranges(mel_w != 0), _ranges((mel_w != 0).T))
    return FFTConstants(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in arrays))


def fused_log_mel(wav: torch.Tensor, sample_rate: int = 22050, mel_size: int = 80,
                  n_fft: int = 1024, win_length: int = 1024, hop_length: int = 256,
                  min_db: Optional[float] = None, max_db: Optional[float] = None,
                  mel_min: float = 0.0, mel_max: Optional[float] = None,
                  log_offset: float = 1e-6, pad: Optional[int] = None,
                  power_eps: float = 0.0, log_floor: float = 0.0,
                  precision: str = 'highest') -> torch.Tensor:
    """Log-mel: wav (B, T) float32 -> (B, mel_size, n_frames).

    ``precision`` takes the JAX kernel's modes, 'highest', 'bf16x3' and
    'default' (:data:`PRECISIONS`), and computes each of them as the fp64
    kernel (on the CPU the plain version) computes 'highest': no bf16 path
    is built, and each result is at least as exact as JAX's in that mode.
    Any other value raises. ``launches_by_mode`` counts the launches by the
    mode asked for.

    ``pad`` defaults to n_fft // 2 (centered); the HiFi-GAN convention is
    :func:`fused_hifigan_mel`. Requires hop | n_fft and n_fft == win_length
    (:func:`_kernel_geometry`), on a CPU tensor as on a CUDA one, where the
    kernel runs on its FFT or its direct path (:func:`fft_path`). Any T >= 1
    takes any pad, by numpy's reflect rule
    (:func:`~pytorch_sound_tpu_torch.ops.mel.reflect_index`); input shorter
    than one frame gives (B, mel_size, 0) and launches nothing.

    The kernel takes float32 and has no gradient of its own (as the JAX
    kernel has none): on a CUDA tensor that requires a gradient while
    autograd records, or of another dtype, it raises rather than return a
    result without ``grad_fn`` or a cast one. The differentiable form is
    :func:`fused_hifigan_mel_trainable`.
    """
    return _log_mel(False, wav, sample_rate, mel_size, n_fft, win_length, hop_length,
                    min_db, max_db, mel_min, mel_max, log_offset, pad, power_eps, log_floor,
                    precision)


def _direct_log_mel(*args, **kwargs) -> torch.Tensor:
    """:func:`fused_log_mel` (same arguments) on the direct DFT whatever the
    n_fft, so that the two paths are timed and checked against each other on
    one geometry (``chip_smoke.py``, ``logmel_probe.py`` and the card tests
    call it; no entry point of the package does). Counted in
    ``fused_log_mel.launches`` and ``direct_launches``."""
    return _log_mel(True, **_arguments(_LOG_MEL_SIGNATURE, args, kwargs))


def _arguments(signature, args, kwargs) -> dict:
    """The arguments of a call with ``signature`` by name, defaults filled in."""
    bound = signature.bind(*args, **kwargs)
    bound.apply_defaults()
    return bound.arguments


def _log_mel(direct, wav, sample_rate, mel_size, n_fft, win_length, hop_length, min_db,
             max_db, mel_min, mel_max, log_offset, pad, power_eps, log_floor, precision):
    """:func:`fused_log_mel`, on the direct DFT at any n_fft where ``direct``."""
    if wav.ndim != 2:
        raise ValueError('fused_log_mel expects (B, T), got %s' % (tuple(wav.shape),))
    if precision not in PRECISIONS:
        raise ValueError('precision is one of %s, got %r' % (PRECISIONS, precision))
    _kernel_geometry(n_fft, hop_length, win_length)
    pad = n_fft // 2 if pad is None else pad
    lo = mel_ops.db_to_log(min_db) if min_db else -np.inf
    hi = mel_ops.db_to_log(max_db) if max_db else np.inf
    if wav.device.type == 'cpu':
        mel_filter = mel_ops.cached_mel_filter(sample_rate, n_fft, mel_size,
                                               mel_min, mel_max)
        return mel_ops.log_mel(wav, mel_filter, n_fft, hop_length, win_length, pad,
                               power_eps, log_floor, log_offset, lo, hi)
    if wav.device.type != 'cuda':
        raise RuntimeError('fused_log_mel runs on cpu or cuda, not %s' % wav.device)

    if wav.dtype != torch.float32 or not wav.is_contiguous():
        raise ValueError('the log-mel kernel takes contiguous float32 input, got %s%s'
                         % (wav.dtype, '' if wav.is_contiguous() else ', not contiguous'))
    if wav.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            'the log-mel kernel has no gradient: call it under torch.no_grad() or on '
            'a detached tensor, or use fused_hifigan_mel_trainable')
    b, t = wav.shape
    if t < 1 or pad < 0:
        raise ValueError('fused_log_mel takes T >= 1 and pad >= 0, got T %d, pad %d'
                         % (t, pad))
    n_frames = mel_ops.n_frames(t, n_fft, hop_length, pad)
    out = torch.empty((b, mel_size, n_frames), dtype=torch.float32, device=wav.device)
    if n_frames == 0 or b == 0:
        return out
    direct = direct or not fft_path(n_fft)
    c = _constants(sample_rate, n_fft, win_length, mel_size, mel_min, mel_max,
                   str(wav.device), direct)
    with torch.cuda.device(wav.device):
        code = _build.library().logmel_forward(
            wav.data_ptr(), out.data_ptr(), b, t, pad, n_fft, hop_length, n_frames,
            c.window.data_ptr(), c.twiddles.data_ptr(), c.split.data_ptr(),
            c.mel_w.shape[1], c.mel_w.data_ptr(), c.bands.data_ptr(), mel_size,
            power_eps, log_floor, log_offset, lo, hi, int(direct),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'logmel_forward')
    fused_log_mel.launches += 1
    fused_log_mel.launches_by_mode[precision] += 1
    if direct:
        fused_log_mel.direct_launches += 1
    return out


fused_log_mel.launches = 0
fused_log_mel.launches_by_mode = dict.fromkeys(PRECISIONS, 0)   # by the precision asked for
fused_log_mel.direct_launches = 0     # of launches, those on the direct path
_LOG_MEL_SIGNATURE = inspect.signature(fused_log_mel)


def fused_hifigan_mel(wav: torch.Tensor, sampling_rate: int = 22050,
                      n_fft: int = 1024, window_size: int = 1024,
                      hop_size: int = 256, num_mels: int = 80,
                      fmin: float = 0.0, fmax: Optional[float] = 8000.0,
                      precision: str = 'highest') -> torch.Tensor:
    """Fused version of ``ops.mel.hifigan_mel_spectrogram``:
    (n_fft-hop)//2 reflect pad, sqrt(power + 1e-9), log(clamp(mel, 1e-5)).
    ``precision`` as :func:`fused_log_mel` takes it (JAX passes its keywords
    through)."""
    return fused_log_mel(
        wav, sampling_rate, num_mels, n_fft, window_size, hop_size,
        mel_min=fmin, mel_max=fmax, pad=(n_fft - hop_size) // 2,
        power_eps=1e-9, log_floor=1e-5, precision=precision)


def hifigan_mel_vjp(wav: torch.Tensor, grad: torch.Tensor, sampling_rate: int = 22050,
                    n_fft: int = 1024, window_size: int = 1024, hop_size: int = 256,
                    num_mels: int = 80, fmin: float = 0.0,
                    fmax: Optional[float] = 8000.0) -> torch.Tensor:
    """Plain version of K4's backward: the VJP of the composite
    ``ops.mel.hifigan_mel_spectrogram`` (at the given settings) at ``wav``
    for the cotangent ``grad`` (the JAX package's ``_fhm_bwd``), by
    autograd."""
    with torch.enable_grad():
        w = wav.detach().requires_grad_(True)
        mel = mel_ops.hifigan_mel_spectrogram(w, sampling_rate, n_fft, window_size,
                                              hop_size, num_mels, fmin, fmax)
        dwav, = torch.autograd.grad(mel, w, grad)
    return dwav


def hifigan_mel_backward(wav: torch.Tensor, grad: torch.Tensor, sampling_rate: int = 22050,
                         n_fft: int = 1024, window_size: int = 1024, hop_size: int = 256,
                         num_mels: int = 80, fmin: float = 0.0,
                         fmax: Optional[float] = 8000.0) -> torch.Tensor:
    """K4's backward, by default at the HiFi-GAN settings (22.05 kHz, n_fft
    1024, hop 256, 80 mels to 8 kHz): wav (B, T), grad (B, num_mels, frames)
    -> dwav (B, T). Any geometry of :func:`fused_hifigan_mel` takes it.

    On a CPU tensor, :func:`hifigan_mel_vjp`. On a CUDA tensor, the backward
    kernels of ``csrc/logmel.cu`` (the frames' gradients, by an inverse FFT
    on the FFT path or the direct adjoint DFT on the direct path, into
    (B, frames, n_fft) scratch, then the overlap-add and the reflect pad's
    adjoint), counted once per call in
    ``fused_hifigan_mel_trainable.bwd_launches``, or an error. Input shorter
    than one frame has a zero gradient and launches nothing.
    """
    return _mel_backward(False, wav, grad, sampling_rate, n_fft, window_size, hop_size,
                         num_mels, fmin, fmax)


_BACKWARD_SIGNATURE = inspect.signature(hifigan_mel_backward)


def _direct_backward(*args, **kwargs) -> torch.Tensor:
    """:func:`hifigan_mel_backward` (same arguments) on the direct adjoint
    DFT whatever the n_fft, as :func:`_direct_log_mel`."""
    return _mel_backward(True, **_arguments(_BACKWARD_SIGNATURE, args, kwargs))


def _mel_backward(direct, wav, grad, sampling_rate, n_fft, window_size, hop_size, num_mels,
                  fmin, fmax):
    """:func:`hifigan_mel_backward`, on the direct path at any n_fft where
    ``direct``."""
    settings = (sampling_rate, n_fft, window_size, hop_size, num_mels, fmin, fmax)
    if wav.device.type == 'cpu':
        return hifigan_mel_vjp(wav, grad, *settings)
    if wav.device.type != 'cuda':
        raise RuntimeError('the log-mel backward runs on cpu or cuda, not %s' % wav.device)
    _kernel_geometry(n_fft, hop_size, window_size)
    hop, n_mels = hop_size, num_mels
    if wav.dtype != torch.float32 or not wav.is_contiguous() or wav.ndim != 2:
        raise ValueError('the log-mel backward kernel takes contiguous float32 (B, T)')
    b, t = wav.shape
    pad = (n_fft - hop) // 2
    n_frames = mel_ops.n_frames(t, n_fft, hop, pad)
    grad = grad.to(torch.float32).contiguous()
    if tuple(grad.shape) != (b, n_mels, n_frames) or grad.device != wav.device:
        raise ValueError('grad of shape %s on %s for wav %s'
                         % (tuple(grad.shape), grad.device, tuple(wav.shape)))
    if n_frames == 0 or b == 0:
        return torch.zeros_like(wav)
    direct = direct or not fft_path(n_fft)
    c = _constants(sampling_rate, n_fft, window_size, n_mels, fmin, fmax, str(wav.device),
                   direct)
    dframes = torch.empty((b, n_frames, n_fft), dtype=torch.float32, device=wav.device)
    dwav = torch.empty_like(wav)
    with torch.cuda.device(wav.device):
        code = _build.library().logmel_backward(
            wav.data_ptr(), grad.data_ptr(), dframes.data_ptr(), dwav.data_ptr(),
            b, t, pad, n_fft, hop, n_frames,
            c.window.data_ptr(), c.twiddles.data_ptr(), c.split.data_ptr(),
            c.mel_w.shape[1], c.mel_w.data_ptr(), c.bands.data_ptr(),
            c.bin_mels.data_ptr(), n_mels, 1e-9, 1e-5, int(direct),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'logmel_backward')
    fused_hifigan_mel_trainable.bwd_launches += 1
    return dwav


class _TrainableMel(torch.autograd.Function):
    """K4: the log-mel kernel forward, its backward kernel (recomputing from
    the saved waveform) on a CUDA tensor."""

    @staticmethod
    def forward(ctx, wav, precision):
        ctx.save_for_backward(wav)
        out = fused_hifigan_mel(wav, precision=precision)
        if wav.device.type == 'cuda' and out.numel():
            fused_hifigan_mel_trainable.launches += 1
            fused_hifigan_mel_trainable.launches_by_mode[precision] += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        wav, = ctx.saved_tensors
        return hifigan_mel_backward(wav, grad), None


def fused_hifigan_mel_trainable(wav: torch.Tensor, precision: str = 'highest'
                                ) -> torch.Tensor:
    """Differentiable HiFi-GAN mel (JAX ``fused_hifigan_mel_trainable``,
    ``ops/pallas/logmel.py:274``): wav (B, T) float32 -> (B, 80, frames).

    Forward: :func:`fused_hifigan_mel`, the log-mel kernel on a CUDA tensor
    (counted in ``fused_log_mel.launches`` and, per call, in this function's
    ``launches``), the plain version on a CPU tensor. Backward:
    :func:`hifigan_mel_backward`, recomputed from the saved waveform as the
    JAX package's ``_fhm_bwd`` does: the backward kernel on a CUDA tensor
    (counted in ``bwd_launches``), the VJP of the plain composite on a CPU
    tensor.

    ``precision`` takes the JAX kernel's modes (:data:`PRECISIONS`; JAX's
    default is 'bf16x3', the port's 'highest') and computes each as
    :func:`fused_log_mel` does: the fp64 kernel on the card, the fp32 plain
    version on the CPU, each at least as exact as JAX's mode. Any other
    value raises. The backward is the composite's VJP in every mode, as JAX's
    ``_fhm_bwd`` ignores ``precision``. ``launches_by_mode`` counts the
    forward launches by the mode asked for.
    """
    if precision not in PRECISIONS:
        raise ValueError('precision is one of %s, got %r' % (PRECISIONS, precision))
    return _TrainableMel.apply(wav, precision)


fused_hifigan_mel_trainable.launches = 0
fused_hifigan_mel_trainable.launches_by_mode = dict.fromkeys(PRECISIONS, 0)
fused_hifigan_mel_trainable.bwd_launches = 0
