"""Functional STFT / iSTFT in plain PyTorch.

Counterpart of ``pytorch_sound_tpu/ops/stft.py``, with its semantics:

- :func:`stft` / :func:`istft` follow ``torch.stft`` / ``torch.istft``:
  any scipy window centered in ``n_fft``, optional centered padding, the
  one-sided spectrum as (real, imag), each (..., F, T); ``istft`` divides by
  the squared window's overlap-add and, for an explicit ``length``, crops
  ``[n_fft // 2, n_fft // 2 + length)`` of the raw overlap-add, zero-padding
  a short one.
- :func:`conv_stft` / :func:`conv_istft` are the conv-basis STFT: a reflect
  pad of ``filter_length // 2``, (magnitude, phase), and the pinv basis with
  the squared-window envelope for the inverse.

The JAX package computes the DFT with ``jnp.fft.rfft`` or a matmul against
the real DFT basis (``method``; the matmul exists because its TPU had no
complex dtype) and reaches no TPU kernel here, so neither does the port:
``'fft'`` (the default, ``'auto'``) is ``torch.fft.rfft`` / ``irfft``,
``'matmul'`` the same basis product through ``torch.matmul``. Outputs keep
the input's float dtype; constants follow it onto its device once
(:func:`~pytorch_sound_tpu_torch.utils.tensor.device_constant`).
"""

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch.ops import filters
from pytorch_sound_tpu_torch.utils.tensor import device_constant


def _method(method: str) -> str:
    if method == 'auto':
        return 'fft'
    if method not in ('fft', 'matmul'):
        raise ValueError("method must be 'auto', 'fft' or 'matmul', got %r" % (method,))
    return method


def reflect_index(t: int, pad: int) -> np.ndarray:
    """Source sample of each position of a (pad, pad) reflect pad of t
    samples, by numpy's rule (``np.pad(mode='reflect')``, which ``jnp.pad``
    follows): for pad >= t the signal reflects again and again, a period of
    2 (t - 1); t == 1 repeats its one sample."""
    q = np.arange(-pad, t + pad)
    if t == 1:
        return np.zeros_like(q)
    period = 2 * (t - 1)
    q = q % period
    return np.where(q < t, q, period - q)


def pad_last(x: torch.Tensor, pad: int, mode: str = 'reflect') -> torch.Tensor:
    """``jnp.pad`` of the last axis by ``pad`` a side: 'constant' (zeros) or
    'reflect' (numpy's rule, also where the pad reaches past the signal)."""
    if mode == 'constant':
        return F.pad(x, (pad, pad))
    if mode != 'reflect':
        raise ValueError("pad_mode must be 'reflect' or 'constant', got %r" % (mode,))
    t = x.shape[-1]
    if pad >= t:
        return x[..., torch.from_numpy(reflect_index(t, pad)).to(x.device)]
    lead = x.shape[:-1]
    return F.pad(x.reshape(-1, 1, t), (pad, pad), mode='reflect').reshape(*lead, t + 2 * pad)


def frame(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """Overlapping frames of ``x`` (..., T): (..., n_frames, frame_length), a
    view; no frame where T < frame_length."""
    if x.shape[-1] < frame_length:
        return x.new_zeros((*x.shape[:-1], 0, frame_length))
    return x.unfold(-1, frame_length, hop_length)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add (..., n_frames, L) to (..., (n_frames - 1) * hop + L).

    Where hop | L this is the JAX package's sum of L / hop shifted reshapes,
    in its order; otherwise ``F.fold``.
    """
    *batch, n_frames, length = frames.shape
    out_len = (n_frames - 1) * hop_length + length
    if length % hop_length == 0:
        flat_len = n_frames * hop_length
        out = frames.new_zeros((*batch, out_len))
        for r in range(length // hop_length):
            chunk = frames[..., r * hop_length:(r + 1) * hop_length].reshape(*batch, flat_len)
            out = out + F.pad(chunk, (r * hop_length, out_len - flat_len - r * hop_length))
        return out
    cols = frames.reshape(-1, n_frames, length).transpose(1, 2)
    out = F.fold(cols, (1, out_len), (1, length), stride=(1, hop_length))
    return out.reshape(*batch, out_len)


@functools.lru_cache(maxsize=32)
def _cached_stft_basis(n_fft: int, win_length: int, window) -> np.ndarray:
    return filters.stft_basis(n_fft, win_length, window)


@functools.lru_cache(maxsize=32)
def cached_window(n_fft: int, win_length: int, window='hann') -> np.ndarray:
    """Any scipy window (name or (name, parameter)), periodic, centered in
    n_fft; float64."""
    return filters.pad_center(filters.get_window_array(window, win_length), n_fft)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: Optional[int] = None,
         window='hann', center: bool = True, pad_mode: str = 'reflect',
         method: str = 'auto') -> Tuple[torch.Tensor, torch.Tensor]:
    """Short-time Fourier transform of (..., T): (real, imag), each
    (..., n_fft // 2 + 1, frames), as ``torch.stft(onesided=True,
    normalized=False)``."""
    win_length = win_length or n_fft
    if center:
        x = pad_last(x, n_fft // 2, pad_mode)
    frames = frame(x, n_fft, hop_length)                       # (..., T, n_fft)
    method = _method(method)
    if frames.shape[-2] == 0:
        # shorter than one frame: JAX's empty (..., F, 0) pair, without an
        # FFT (oneMKL and cuFFT refuse a zero batch)
        empty = frames.new_zeros((*frames.shape[:-2], n_fft // 2 + 1, 0))
        return empty, empty.clone()
    if method == 'matmul':
        basis = device_constant(_cached_stft_basis(n_fft, win_length, window), x)
        proj = torch.matmul(basis, frames.transpose(-1, -2))    # (..., 2F, T)
        real, imag = torch.chunk(proj, 2, dim=-2)
        return real, imag
    win = device_constant(cached_window(n_fft, win_length, window), x)
    spec = torch.fft.rfft(frames * win, dim=-1).transpose(-1, -2)
    return spec.real, spec.imag


def magphase(real: torch.Tensor, imag: torch.Tensor,
             power_eps: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Magnitude ``sqrt(re² + im² + eps)`` and phase ``atan2(im, re)``."""
    return torch.sqrt(real * real + imag * imag + power_eps), torch.atan2(imag, real)


def spectrogram_magnitude(x: torch.Tensor, n_fft: int, hop_length: int,
                          win_length: Optional[int] = None, center: bool = True,
                          pad_mode: str = 'reflect', power_eps: float = 0.0,
                          method: str = 'auto') -> torch.Tensor:
    """|STFT| (..., F, T)."""
    real, imag = stft(x, n_fft, hop_length, win_length, center=center,
                      pad_mode=pad_mode, method=method)
    return torch.sqrt(real * real + imag * imag + power_eps)


@functools.lru_cache(maxsize=32)
def _cached_irdft_basis(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real inverse-rDFT bases with the spectral weights folded in (1 for DC
    and Nyquist, 2 elsewhere, all / n_fft): irfft = Re @ C + Im @ mS."""
    cutoff = n_fft // 2 + 1
    basis = filters.dft_basis(n_fft)
    w = np.full((cutoff, 1), 2.0 / n_fft)
    w[0] = w[-1] = 1.0 / n_fft
    return basis[:cutoff] * w, basis[cutoff:] * w


def inverse_rdft(real: torch.Tensor, imag: torch.Tensor, n_fft: int,
                 method: str = 'auto') -> torch.Tensor:
    """Inverse one-sided DFT of (..., T, F) real / imag: (..., T, n_fft)."""
    if _method(method) == 'fft':
        return torch.fft.irfft(torch.complex(real, imag), n=n_fft, dim=-1)
    cos_b, msin_b = _cached_irdft_basis(n_fft)
    return (torch.matmul(real, device_constant(cos_b, real))
            + torch.matmul(imag, device_constant(msin_b, imag)))


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int,
          win_length: Optional[int] = None, window='hann', center: bool = True,
          length: Optional[int] = None, eps: float = 1e-11,
          method: str = 'auto') -> torch.Tensor:
    """Inverse STFT of (..., F, T) real / imag to (..., samples), with the
    window-envelope normalization of ``torch.istft``."""
    win_length = win_length or n_fft
    win_np = cached_window(n_fft, win_length, window)
    frames = inverse_rdft(real.transpose(-1, -2), imag.transpose(-1, -2), n_fft,
                          method=method)                       # (..., T, n_fft)
    win = device_constant(win_np, frames)
    y = overlap_add(frames * win, hop_length)
    n_frames = frames.shape[-2]
    env = overlap_add((win * win).expand(n_frames, n_fft), hop_length)
    y = y / (env + eps)
    if center:
        start = n_fft // 2
        # torch.istft: with an explicit length, [start, start + length) of
        # the raw overlap-add, zero-padded if short; else n_fft // 2 off each side
        end = start + length if length is not None else y.shape[-1] - start
        if y.shape[-1] < end:
            y = F.pad(y, (0, end - y.shape[-1]))
        y = y[..., start:end]
    elif length is not None:
        if y.shape[-1] < length:
            y = F.pad(y, (0, length - y.shape[-1]))
        y = y[..., :length]
    return y


def conv_stft(x: torch.Tensor, filter_length: int = 1024, hop_length: int = 512,
              win_length: Optional[int] = None, window='hann',
              method: str = 'auto') -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv-basis STFT: reflect pad filter_length // 2, windowed DFT,
    (magnitude, phase): the centered :func:`stft` and :func:`magphase`."""
    win_length = win_length or filter_length
    real, imag = stft(x, filter_length, hop_length, win_length, window,
                      center=True, pad_mode='reflect', method=method)
    return magphase(real, imag)


@functools.lru_cache(maxsize=16)
def _cached_istft_pinv_basis(n_fft: int, hop_length: int, win_length: int,
                             window) -> np.ndarray:
    return filters.istft_pinv_basis(n_fft, hop_length, win_length, window)


@functools.lru_cache(maxsize=16)
def _cached_square_window(n_fft: int, win_length: int, window) -> np.ndarray:
    win = filters.pad_center(filters.get_window_array(window, win_length), n_fft)
    return win * win


def conv_istft(magnitude: torch.Tensor, phase: torch.Tensor,
               filter_length: int = 1024, hop_length: int = 512,
               win_length: Optional[int] = None, window='hann',
               eps: float = 1e-9) -> torch.Tensor:
    """Inverse of :func:`conv_stft`: the pinv basis per frame, overlap-add,
    the squared-window envelope, the filter_length / hop gain, and the pad
    cut off."""
    win_length = win_length or filter_length
    comp = torch.cat([magnitude * torch.cos(phase), magnitude * torch.sin(phase)],
                     dim=-2)                                   # (..., 2F, T)
    inv_basis = device_constant(
        _cached_istft_pinv_basis(filter_length, hop_length, win_length, window), comp)
    frames = torch.matmul(comp.transpose(-1, -2), inv_basis)   # (..., T, n)
    y = overlap_add(frames, hop_length)
    sq = device_constant(_cached_square_window(filter_length, win_length, window), comp)
    env = overlap_add(sq.expand(comp.shape[-1], filter_length), hop_length) + eps
    y = y / env * (filter_length / hop_length)
    pad = filter_length // 2
    return y[..., pad:y.shape[-1] - pad]
