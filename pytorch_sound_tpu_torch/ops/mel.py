"""Log-mel / MFCC feature extraction in plain PyTorch.

Counterpart of ``pytorch_sound_tpu/ops/mel.py``. :func:`log_mel` and its two
conventions are the plain version of the log-mel kernel
(``ops/cuda/logmel.py``): the CPU path of ``InterfaceHifiGAN.encode`` and the
reference the kernel is held against on the card. Autograd of
:func:`hifigan_mel_spectrogram` is also the backward of the trainable log-mel
(K4), as in the JAX package. :func:`audio2mel` (MelGAN's log10 mel) and the
MFCC (:func:`mel_to_mfcc`, :func:`mfcc`) run on :mod:`.stft`, which the JAX
package computes outside any TPU kernel too. Filterbanks, windows and the DCT
come from :mod:`.filters`, the JAX package's numpy formulas.
"""

import functools
from typing import Optional

import numpy as np
import torch

from pytorch_sound_tpu_torch.ops import filters
from pytorch_sound_tpu_torch.ops import stft as stft_ops
from pytorch_sound_tpu_torch.ops.stft import pad_last, reflect_index  # noqa: F401
from pytorch_sound_tpu_torch.utils.tensor import device_constant


@functools.lru_cache(maxsize=32)
def cached_mel_filter(sample_rate: int, n_fft: int, n_mels: int,
                      fmin: float, fmax: Optional[float],
                      htk: bool = False,
                      norm: Optional[str] = 'slaney') -> np.ndarray:
    """(n_mels, 1 + n_fft // 2) float32 filterbank (librosa-compatible)."""
    return np.asarray(
        filters.mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax,
                               htk=htk, norm=norm),
        dtype=np.float32)


@functools.lru_cache(maxsize=8)
def cached_dct(n_mfcc: int, n_mels: int, norm: Optional[str] = 'ortho') -> np.ndarray:
    """(n_mfcc, n_mels) float32 DCT-II matrix."""
    return np.asarray(filters.dct_matrix(n_mfcc, n_mels, norm), dtype=np.float32)


def _cached_window(n_fft: int, win_length: int) -> np.ndarray:
    """Periodic Hann window of ``win_length``, center-padded to ``n_fft``, in
    float64: :func:`log_mel` casts it to the input's dtype, so a float64 run
    has no float32-rounded window (whose leakage floor would cap its
    accuracy on pure tones)."""
    return stft_ops.cached_window(n_fft, win_length)


def db_to_log(db: float) -> float:
    """Decibel -> natural-log power scale: ``db / 10 * ln(10)``."""
    return float(db / 10.0 * np.log(10.0))


def n_frames(t: int, n_fft: int, hop_length: int, pad: int) -> int:
    """Frames of an uncentered STFT over t samples padded by ``pad`` a side;
    0 where the padded signal is shorter than one window, as in JAX."""
    return max(0, 1 + (t + 2 * pad - n_fft) // hop_length)


def log_mel(wav: torch.Tensor, mel_filter: np.ndarray, n_fft: int,
            hop_length: int, win_length: int, pad: int,
            power_eps: float = 0.0, log_floor: float = 0.0,
            log_offset: float = 1e-6, lo: float = -np.inf,
            hi: float = np.inf) -> torch.Tensor:
    """wav (..., T) -> log-mel (..., n_mels, frames), in wav's float dtype.

    Reflect pad by ``pad`` -> uncentered STFT (periodic Hann) ->
    ``sqrt(re² + im² + power_eps)`` -> mel matmul ->
    ``log(max(mel, log_floor))`` if ``log_floor > 0`` else
    ``log(mel + log_offset)`` -> clip to [lo, hi]. Both conventions of the
    JAX package are this function at different arguments. Any length takes
    the pad (:func:`reflect_index` where pad >= T); a signal shorter than
    one frame gives (..., n_mels, 0), as the JAX composite does.
    """
    lead = wav.shape[:-1]
    t = wav.shape[-1]
    x = wav.reshape(-1, t)
    if n_frames(t, n_fft, hop_length, pad) == 0:
        # sliced from x, so autograd reaches wav with a zero gradient
        return x[:, None, :0].expand(-1, mel_filter.shape[0], -1).reshape(
            *lead, mel_filter.shape[0], 0)
    if pad:
        x = pad_last(x, pad)
    window = device_constant(_cached_window(n_fft, win_length), x)
    spec = torch.stft(x, n_fft, hop_length, n_fft, window=window,
                      center=False, return_complex=True)
    spec = torch.view_as_real(spec)
    mag = torch.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2 + power_eps)
    mel = torch.matmul(device_constant(mel_filter, x), mag)
    if log_floor > 0.0:
        out = torch.log(torch.clamp(mel, min=log_floor))
    else:
        out = torch.log(mel + log_offset)
    out = torch.clamp(out, min=lo, max=hi)
    return out.reshape(*lead, *out.shape[1:])


def log_mel_spectrogram(wav: torch.Tensor, sample_rate: int, mel_size: int,
                        n_fft: int, win_length: int, hop_length: int,
                        min_db: Optional[float] = None, max_db: Optional[float] = None,
                        mel_min: float = 0.0, mel_max: Optional[float] = None,
                        log_offset: float = 1e-6) -> torch.Tensor:
    """Centered-STFT log-mel, (..., mel_size, T).

    As in the JAX package, the STFT runs at ``win_length`` (``n_fft`` only
    sizes the mel filterbank), and a zero ``min_db``/``max_db`` means no clip.
    """
    mel_filter = cached_mel_filter(sample_rate, n_fft, mel_size, mel_min, mel_max)
    return log_mel(wav, mel_filter, win_length, hop_length, win_length,
                   pad=win_length // 2, log_offset=log_offset,
                   lo=db_to_log(min_db) if min_db else -np.inf,
                   hi=db_to_log(max_db) if max_db else np.inf)


def hifigan_mel_spectrogram(wav: torch.Tensor, sampling_rate: int = 22050,
                            n_fft: int = 1024, window_size: int = 1024,
                            hop_size: int = 256, num_mels: int = 80,
                            fmin: float = 0.0,
                            fmax: Optional[float] = 8000.0) -> torch.Tensor:
    """HiFi-GAN's mel frontend: (n_fft-hop)//2 reflect pad, uncentered STFT,
    sqrt(power + 1e-9), mel matmul, log(clamp(., 1e-5))."""
    mel_filter = cached_mel_filter(sampling_rate, n_fft, num_mels, fmin, fmax)
    return log_mel(wav, mel_filter, n_fft, hop_size, window_size,
                   pad=(n_fft - hop_size) // 2, power_eps=1e-9, log_floor=1e-5)


def audio2mel(wav: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
              win_length: int = 1024, sampling_rate: int = 22050,
              n_mel_channels: int = 80, mel_fmin: float = 0.0,
              mel_fmax: Optional[float] = None, method: str = 'auto') -> torch.Tensor:
    """MelGAN's log10 mel (Audio2Mel): (n_fft - hop) // 2 reflect pad,
    uncentered STFT, magnitude, mel, ``log10(max(mel, 1e-5))``."""
    wav = pad_last(wav, (n_fft - hop_length) // 2)
    mag = stft_ops.spectrogram_magnitude(wav, n_fft, hop_length, win_length,
                                         center=False, method=method)
    mel_filter = device_constant(
        cached_mel_filter(sampling_rate, n_fft, n_mel_channels, mel_fmin, mel_fmax), mag)
    return torch.log10(torch.clamp(torch.matmul(mel_filter, mag), min=1e-5))


def mel_to_mfcc(mel_spec: torch.Tensor, n_mfcc: int, mel_size: int,
                norm: Optional[str] = 'ortho') -> torch.Tensor:
    """(..., mel_size, T) log-mel -> (..., n_mfcc, T) cepstral coefficients."""
    return torch.matmul(device_constant(cached_dct(n_mfcc, mel_size, norm), mel_spec),
                        mel_spec)


def mfcc(wav: torch.Tensor, sample_rate: int, mel_size: int, n_fft: int,
         win_length: int, n_mfcc: int, hop_length: int, min_db: float, max_db: float,
         mel_min: float = 0.0, mel_max: Optional[float] = None,
         norm: Optional[str] = 'ortho') -> torch.Tensor:
    """Wave -> centered log-mel (:func:`log_mel_spectrogram`) -> DCT cepstrum."""
    mel = log_mel_spectrogram(wav, sample_rate, mel_size, n_fft, win_length, hop_length,
                              min_db, max_db, mel_min, mel_max)
    return mel_to_mfcc(mel, n_mfcc, mel_size, norm)
