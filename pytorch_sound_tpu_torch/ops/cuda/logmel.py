"""Fused log-mel frontend: wrapper of the CUDA kernel ``csrc/logmel.cu``.

Counterpart of ``pytorch_sound_tpu/ops/pallas/logmel.py`` (``fused_log_mel``,
``fused_hifigan_mel``): reflect pad -> frames -> windowed DFT over the bins the
mel filterbank uses -> magnitude -> mel -> log -> clip, in one launch; the
spectrum never reaches device memory.

The wrapper dispatches on the tensor's device: on the CPU it runs the plain
version (:func:`pytorch_sound_tpu_torch.ops.mel.log_mel`), on a CUDA tensor it
launches the kernel or raises. :func:`fused_hifigan_mel_trainable` (K4) wraps
the same kernel in an autograd function for the training loss.
"""

import functools
from typing import Optional

import numpy as np
import torch

from pytorch_sound_tpu_torch.ops import filters
from pytorch_sound_tpu_torch.ops import mel as mel_ops
from pytorch_sound_tpu_torch.ops.cuda import _build

SOURCE = 'pytorch_sound_tpu_torch/csrc/logmel.cu'


@functools.lru_cache(maxsize=8)
def _constants(sample_rate: int, n_fft: int, win_length: int, n_mels: int,
               fmin: float, fmax: Optional[float], device: str):
    """(cos (n_fft, F), sin (n_fft, F)) in float64 and mel (n_mels, F) in
    float32, on ``device``.

    F counts only the spectral bins the mel filterbank weights (372 of 513 at
    fmax 8 kHz); higher bins have exactly-zero mel weight and are dropped.
    """
    cutoff = n_fft // 2 + 1
    mel = filters.mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    nz = np.nonzero(np.any(mel != 0.0, axis=0))[0]
    f_used = int(nz[-1]) + 1 if nz.size else cutoff
    basis = filters.stft_basis(n_fft, win_length)   # (2*cutoff, n_fft)
    arrays = ((basis[:f_used].T, np.float64), (basis[cutoff:cutoff + f_used].T, np.float64),
              (mel[:, :f_used], np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)
                 for a, dt in arrays)


def fused_log_mel(wav: torch.Tensor, sample_rate: int = 22050, mel_size: int = 80,
                  n_fft: int = 1024, win_length: int = 1024, hop_length: int = 256,
                  min_db: Optional[float] = None, max_db: Optional[float] = None,
                  mel_min: float = 0.0, mel_max: Optional[float] = None,
                  log_offset: float = 1e-6, pad: Optional[int] = None,
                  power_eps: float = 0.0, log_floor: float = 0.0) -> torch.Tensor:
    """Log-mel: wav (B, T) float32 -> (B, mel_size, n_frames).

    ``pad`` defaults to n_fft // 2 (centered); the HiFi-GAN convention is
    :func:`fused_hifigan_mel`. Requires hop | n_fft and n_fft == win_length.
    """
    if wav.ndim != 2:
        raise ValueError('fused_log_mel expects (B, T), got %s' % (tuple(wav.shape),))
    if n_fft % hop_length or win_length != n_fft:
        raise ValueError('fused log-mel supports the n_fft == win, hop | n_fft geometry')
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
        raise ValueError('fused_log_mel kernel takes contiguous float32 input')
    b, t = wav.shape
    if not 0 <= pad < t:
        raise ValueError('reflect pad %d needs more than %d samples' % (pad, t))
    n_frames = 1 + (t + 2 * pad - n_fft) // hop_length
    if n_frames < 1:
        raise ValueError('input of %d samples is shorter than one frame' % t)
    cos_b, sin_b, mel_w = _constants(sample_rate, n_fft, win_length, mel_size,
                                     mel_min, mel_max, str(wav.device))
    out = torch.empty((b, mel_size, n_frames), dtype=torch.float32, device=wav.device)
    with torch.cuda.device(wav.device):
        code = _build.library().logmel_forward(
            wav.data_ptr(), out.data_ptr(), b, t, pad, n_fft, hop_length, n_frames,
            cos_b.data_ptr(), sin_b.data_ptr(), cos_b.shape[1],
            mel_w.data_ptr(), mel_size,
            power_eps, log_floor, log_offset, lo, hi,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'logmel_forward')
    fused_log_mel.launches += 1
    return out


fused_log_mel.launches = 0


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


class _TrainableMel(torch.autograd.Function):
    """K4's forward is the log-mel kernel; its backward is autograd of the
    composite formula, recomputed from the saved waveform."""

    @staticmethod
    def forward(ctx, wav):
        ctx.save_for_backward(wav)
        out = fused_hifigan_mel(wav)
        if wav.device.type == 'cuda':
            fused_hifigan_mel_trainable.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        wav, = ctx.saved_tensors
        with torch.enable_grad():
            w = wav.detach().requires_grad_(True)
            mel = mel_ops.hifigan_mel_spectrogram(w)
            dwav, = torch.autograd.grad(mel, w, grad)
        return dwav


def fused_hifigan_mel_trainable(wav: torch.Tensor, precision: str = 'highest'
                                ) -> torch.Tensor:
    """Differentiable HiFi-GAN mel (JAX ``fused_hifigan_mel_trainable``,
    ``ops/pallas/logmel.py:274``): wav (B, T) float32 -> (B, 80, frames).

    Forward: :func:`fused_hifigan_mel`, the log-mel kernel on a CUDA tensor
    (counted in ``fused_log_mel.launches`` and, per call, in this function's
    ``launches``), the plain version on a CPU tensor. Backward: the VJP of the
    plain composite ``ops.mel.hifigan_mel_spectrogram`` at the saved
    waveform, recomputed under autograd. That is the JAX package's own design
    (its ``_fhm_bwd`` is XLA's autodiff of the same formula; it has no
    backward kernel), not a plain version standing in for a kernel. Only
    ``precision='highest'`` exists: the kernel's DFT is fp64.
    """
    if precision != 'highest':
        raise ValueError("precision must be 'highest', got %r" % (precision,))
    return _TrainableMel.apply(wav)


fused_hifigan_mel_trainable.launches = 0
