"""Fused log-mel frontend: wrapper of the CUDA kernels ``csrc/logmel.cu``.

Counterpart of ``pytorch_sound_tpu/ops/pallas/logmel.py`` (``fused_log_mel``,
``fused_hifigan_mel``): reflect pad -> frames -> windowed DFT over the bins the
mel filterbank uses -> magnitude -> mel -> log -> clip, in one launch; the
spectrum never reaches device memory. The card kernel takes the JAX kernel's
geometry, ``win_length == n_fft`` and ``hop_length | n_fft``, on two paths:
an in-block fp64 FFT for a power-of-two ``n_fft`` from 256 to 4096
(:func:`fft_path`), a direct fp64 DFT over the used bins for every other
``n_fft`` (400 / 100 at 16 kHz, 1000 / 250, 128 / 32, 8192 / 2048).

The wrapper dispatches on the tensor's device: on the CPU it runs the plain
version (:func:`pytorch_sound_tpu_torch.ops.mel.log_mel`), on a CUDA tensor it
launches the kernel or raises. :func:`fused_hifigan_mel_trainable` (K4) wraps
the same kernel in an autograd function for the training loss, with a
backward kernel on the same FFT.
"""

import functools
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
    twiddles: torch.Tensor    # FFT path: (n_fft // 2, 2) float64, W_M^e = exp(-2 pi i e / M),
                              # M = n_fft / 2; direct path: (n_fft, 2), exp(-2 pi i j / n_fft)
    split: torch.Tensor       # (f_used, 2) float64, exp(-2 pi i k / n_fft)
    mel_w: torch.Tensor       # (n_mels, f_used) float32, the filterbank's used bins
    bands: torch.Tensor       # (n_mels, 2) int32, each mel's nonzero bins [k0, k1)
    bin_mels: torch.Tensor    # (f_used, 2) int32, the mels [m0, m1) weighting each bin


def fft_path(n_fft: int) -> bool:
    """Whether the kernels take ``n_fft`` on the FFT path (a power of two from
    256 to 4096, ``fft_geometry`` in ``csrc/logmel.cu``); every other
    ``n_fft`` takes the direct DFT."""
    return 256 <= n_fft <= 4096 and not n_fft & (n_fft - 1)


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
               fmin: float, fmax: Optional[float], device: str) -> FFTConstants:
    """The kernels' tables for one geometry, on ``device``.

    f_used counts only the spectral bins the mel filterbank weights (372 of
    513 at fmax 8 kHz); higher bins have exactly-zero mel weight and are never
    formed. Window and twiddles are fp64 from numpy: the kernels call no
    sincos. The twiddles are the FFT's n_fft / 2-point table on the FFT path,
    the n_fft-point one on the direct path.
    """
    mel = filters.mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    nz = np.nonzero(np.any(mel != 0.0, axis=0))[0]
    f_used = int(nz[-1]) + 1 if nz.size else n_fft // 2 + 1
    m = n_fft // 2 if fft_path(n_fft) else n_fft
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
    kernel (on the CPU the plain version) computes 'highest': the fast modes
    are not ported, and each result is at least as exact as JAX's in that
    mode. Any other value raises.

    ``pad`` defaults to n_fft // 2 (centered); the HiFi-GAN convention is
    :func:`fused_hifigan_mel`. Requires hop | n_fft and n_fft == win_length
    (:func:`_kernel_geometry`), on a CPU tensor as on a CUDA one, where the
    kernel runs on its FFT or its direct path (:func:`fft_path`). Any T >= 1
    takes any pad, by numpy's reflect
    rule (:func:`~pytorch_sound_tpu_torch.ops.mel.reflect_index`); input
    shorter than one frame gives (B, mel_size, 0) and launches nothing.

    The kernel takes float32 and has no gradient of its own (as the JAX
    kernel has none): on a CUDA tensor that requires a gradient while
    autograd records, or of another dtype, it raises rather than return a
    result without ``grad_fn`` or a cast one. The differentiable form is
    :func:`fused_hifigan_mel_trainable`.
    """
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
    c = _constants(sample_rate, n_fft, win_length, mel_size, mel_min, mel_max,
                   str(wav.device))
    with torch.cuda.device(wav.device):
        code = _build.library().logmel_forward(
            wav.data_ptr(), out.data_ptr(), b, t, pad, n_fft, hop_length, n_frames,
            c.window.data_ptr(), c.twiddles.data_ptr(), c.split.data_ptr(),
            c.mel_w.shape[1], c.mel_w.data_ptr(), c.bands.data_ptr(), mel_size,
            power_eps, log_floor, log_offset, lo, hi,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'logmel_forward')
    fused_log_mel.launches += 1
    if not fft_path(n_fft):
        fused_log_mel.direct_launches += 1
    return out


fused_log_mel.launches = 0
fused_log_mel.direct_launches = 0     # of launches, those on the direct path


def fused_hifigan_mel(wav: torch.Tensor, sampling_rate: int = 22050,
                      n_fft: int = 1024, window_size: int = 1024,
                      hop_size: int = 256, num_mels: int = 80,
                      fmin: float = 0.0, fmax: Optional[float] = 8000.0) -> torch.Tensor:
    """Fused version of ``ops.mel.hifigan_mel_spectrogram``:
    (n_fft-hop)//2 reflect pad, sqrt(power + 1e-9), log(clamp(mel, 1e-5))."""
    return fused_log_mel(
        wav, sampling_rate, num_mels, n_fft, window_size, hop_size,
        mel_min=fmin, mel_max=fmax, pad=(n_fft - hop_size) // 2,
        power_eps=1e-9, log_floor=1e-5)


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
    c = _constants(sampling_rate, n_fft, window_size, n_mels, fmin, fmax, str(wav.device))
    dframes = torch.empty((b, n_frames, n_fft), dtype=torch.float32, device=wav.device)
    dwav = torch.empty_like(wav)
    with torch.cuda.device(wav.device):
        code = _build.library().logmel_backward(
            wav.data_ptr(), grad.data_ptr(), dframes.data_ptr(), dwav.data_ptr(),
            b, t, pad, n_fft, hop, n_frames,
            c.window.data_ptr(), c.twiddles.data_ptr(), c.split.data_ptr(),
            c.mel_w.shape[1], c.mel_w.data_ptr(), c.bands.data_ptr(),
            c.bin_mels.data_ptr(), n_mels, 1e-9, 1e-5,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'logmel_backward')
    fused_hifigan_mel_trainable.bwd_launches += 1
    return dwav


class _TrainableMel(torch.autograd.Function):
    """K4: the log-mel kernel forward, its backward kernel (recomputing from
    the saved waveform) on a CUDA tensor."""

    @staticmethod
    def forward(ctx, wav):
        ctx.save_for_backward(wav)
        out = fused_hifigan_mel(wav)
        if wav.device.type == 'cuda' and out.numel():
            fused_hifigan_mel_trainable.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        wav, = ctx.saved_tensors
        return hifigan_mel_backward(wav, grad)


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
    tensor. Only ``precision='highest'`` exists: the kernels' FFT is fp64.
    """
    if precision != 'highest':
        raise ValueError("precision must be 'highest', got %r" % (precision,))
    return _TrainableMel.apply(wav)


fused_hifigan_mel_trainable.launches = 0
fused_hifigan_mel_trainable.bwd_launches = 0
