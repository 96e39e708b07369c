"""DSP transform modules: the class API of ``pytorch_sound_tpu/models/transforms.py``
over the port's functional ops.

STFT, LearnableSTFT, LogMelSpectrogram, LogMelScale, STFTTorchAudio,
Audio2Mel, LogMelSpectrogramTorchAudio, SpectrogramMasker, MelToMFCC, MFCC
and PQMF, with the JAX package's constructor arguments and method names. As
there, they are stateless callables over cached constants, except
:class:`LearnableSTFT`, whose two bases are trainable: an ``nn.Module`` here.
They run on whatever device their input lies on.

:class:`LogMelSpectrogram` (and :class:`MFCC` through it) sends every
geometry of the JAX package's fused route, ``win_length == n_fft`` and
``hop_length | n_fft``, to the log-mel kernel's wrapper
(:func:`~pytorch_sound_tpu_torch.ops.cuda.logmel.fused_log_mel`, K2) at any
input rank, its leading dims flattened into the batch: on a CUDA tensor the
kernel runs, on a CPU tensor its plain version. Other geometries take the
composite, as they do in the JAX package on every backend.
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from pytorch_sound_tpu_torch.ops import filters, mel as mel_ops, pqmf as pqmf_ops
from pytorch_sound_tpu_torch.ops import sound as sound_ops
from pytorch_sound_tpu_torch.ops import stft as stft_ops
from pytorch_sound_tpu_torch.ops.cuda.logmel import fused_log_mel
from pytorch_sound_tpu_torch.utils.tensor import device_constant


class STFT:
    """Conv-basis STFT with its exact inverse:
    ``transform(wav (N, T)) -> (mag (N, F, T'), phase)``,
    ``inverse(mag, phase) -> wav`` through the pinv basis and the window
    envelope."""

    def __init__(self, filter_length: int = 1024, hop_length: int = 512,
                 win_length: int = None, window='hann'):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length if win_length else filter_length
        self.window = window
        self.pad_amount = filter_length // 2
        assert filter_length >= self.win_length

    def transform(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return stft_ops.conv_stft(wav, self.filter_length, self.hop_length,
                                  self.win_length, self.window)

    def inverse(self, magnitude: torch.Tensor, phase: torch.Tensor,
                eps: float = 1e-9) -> torch.Tensor:
        return stft_ops.conv_istft(magnitude, phase, self.filter_length, self.hop_length,
                                   self.win_length, self.window, eps=eps)

    __call__ = transform


class LearnableSTFT(nn.Module):
    """STFT whose forward and inverse bases are parameters
    (``forward_basis`` (2F, n), the plain DFT basis; ``inverse_basis``
    (2F, n), the pinv basis without its window), both initialised so that
    the module reproduces :class:`STFT`. ``forward(wav) -> (mag, phase)``;
    ``inverse(mag, phase) -> wav``. A basis with ``trainable_*=False`` is a
    buffer. :func:`learnable_stft_from_jax` carries a flax parameter tree
    over."""

    def __init__(self, filter_length: int = 1024, hop_length: int = 512,
                 win_length: Optional[int] = None, window='hann',
                 trainable_forward: bool = True, trainable_inverse: bool = True):
        super().__init__()
        self.filter_length = filter_length
        self.hop_length = hop_length
        win_len = win_length or filter_length
        assert filter_length >= win_len
        win = filters.pad_center(filters.hann_window(win_len), filter_length)
        fwd = filters.dft_basis(filter_length).astype(np.float32)
        inv = filters.istft_pinv_basis(filter_length, hop_length, win_len, window)
        inv = (inv / win[None, :].clip(1e-12)).astype(np.float32)   # unwindowed
        self.register_buffer('fft_window', torch.from_numpy(win.astype(np.float32)))
        for name, basis, trainable in (('forward_basis', fwd, trainable_forward),
                                       ('inverse_basis', inv, trainable_inverse)):
            if trainable:
                self.register_parameter(name, nn.Parameter(torch.from_numpy(basis)))
            else:
                self.register_buffer(name, torch.from_numpy(basis))

    def forward(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = stft_ops.pad_last(wav, self.filter_length // 2)
        frames = stft_ops.frame(x, self.filter_length, self.hop_length)
        basis = self.forward_basis * self.fft_window[None, :]
        proj = torch.matmul(basis, frames.transpose(-1, -2))    # (..., 2F, T)
        real, imag = torch.chunk(proj, 2, dim=-2)
        return stft_ops.magphase(real, imag)

    def inverse(self, magnitude: torch.Tensor, phase: torch.Tensor,
                eps: float = 1e-9) -> torch.Tensor:
        comp = torch.cat([magnitude * torch.cos(phase), magnitude * torch.sin(phase)],
                         dim=-2)
        basis = self.inverse_basis * self.fft_window[None, :]
        frames = torch.matmul(comp.transpose(-1, -2), basis)     # (..., T, n)
        y = stft_ops.overlap_add(frames, self.hop_length)
        sq = self.fft_window * self.fft_window
        env = stft_ops.overlap_add(sq.expand(comp.shape[-1], self.filter_length),
                                   self.hop_length) + eps
        y = y / env * (self.filter_length / self.hop_length)
        pad = self.filter_length // 2
        return y[..., pad: y.shape[-1] - pad]


def learnable_stft_from_jax(tree: Dict[str, Any], hop_length: int,
                            win_length: Optional[int] = None, window='hann'
                            ) -> LearnableSTFT:
    """The port's :class:`LearnableSTFT` holding a JAX ``LearnableSTFT``'s
    parameter tree (numpy arrays, with or without the 'params' key): both
    bases trainable, ``filter_length`` read from their width."""
    params = tree.get('params', tree)
    module = LearnableSTFT(np.shape(params['forward_basis'])[1], hop_length, win_length,
                           window)
    with torch.no_grad():
        for name in ('forward_basis', 'inverse_basis'):
            getattr(module, name).copy_(torch.from_numpy(np.asarray(params[name], np.float32)))
    return module


class LogMelSpectrogram:
    """Wave -> log-mel: centered STFT magnitude, Slaney mel filterbank,
    log(mel + 1e-6), the dB clip. On the fused geometry (win == n_fft,
    hop | n_fft) through the log-mel kernel's wrapper at any input rank; on
    the card that takes float32 only and no gradient, and raises otherwise
    (:func:`~pytorch_sound_tpu_torch.ops.cuda.logmel.fused_log_mel`)."""

    def __init__(self, sample_rate: int, mel_size: int, n_fft: int, win_length: int,
                 hop_length: int, min_db: float = None, max_db: float = None,
                 mel_min: float = 0., mel_max: float = None):
        self.sample_rate = sample_rate
        self.mel_size = mel_size
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.min_db = min_db
        self.max_db = max_db
        self.mel_min = mel_min
        self.mel_max = mel_max

    def fused(self) -> bool:
        """Whether the geometry takes the log-mel kernel's route."""
        return self.win_length == self.n_fft and self.n_fft % self.hop_length == 0

    def __call__(self, wav: torch.Tensor, log_offset: float = 1e-6) -> torch.Tensor:
        if not self.fused():
            return mel_ops.log_mel_spectrogram(
                wav, self.sample_rate, self.mel_size, self.n_fft, self.win_length,
                self.hop_length, self.min_db, self.max_db, self.mel_min, self.mel_max,
                log_offset=log_offset)
        lead, t = wav.shape[:-1], wav.shape[-1]
        x = wav.reshape(-1, t)
        if x.device.type == 'cuda':         # the kernel takes contiguous input
            x = x.contiguous()
        out = fused_log_mel(x, self.sample_rate, self.mel_size, self.n_fft,
                            self.win_length, self.hop_length, self.min_db, self.max_db,
                            self.mel_min, self.mel_max, log_offset=log_offset)
        return out.reshape(*lead, *out.shape[1:])

    forward = __call__


class LogMelScale:
    """Magnitude computed elsewhere -> clipped log-mel."""

    def __init__(self, sample_rate: int, mel_size: int, n_fft: int,
                 min_db: float, max_db: float, mel_min: float = 0.,
                 mel_max: float = None):
        self.mel_size = mel_size
        self.min_db = mel_ops.db_to_log(min_db)
        self.max_db = mel_ops.db_to_log(max_db)
        self.mel_filter = mel_ops.cached_mel_filter(
            sample_rate, n_fft, mel_size, mel_min, mel_max)

    def __call__(self, magnitude: torch.Tensor, log_offset: float = 1e-6) -> torch.Tensor:
        mel = torch.matmul(device_constant(self.mel_filter, magnitude), magnitude)
        return torch.clamp(torch.log(mel + log_offset), self.min_db, self.max_db)

    forward = __call__


class STFTTorchAudio:
    """``torch.stft``-interface STFT: centered reflect pad, Hann window,
    (mag, phase), the exact iSTFT as inverse."""

    def __init__(self, filter_length: int = 1024, hop_length: int = 512,
                 win_length: int = None, n_fft: int = None, window: str = 'hann'):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length if win_length else filter_length
        if window != 'hann':
            raise NotImplementedError(f'{window} is not implemented ! Use hann')
        self.n_fft = n_fft if n_fft else self.win_length

    def forward(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return stft_ops.stft(wav, self.n_fft, self.hop_length, self.win_length,
                             center=True, pad_mode='reflect')

    def transform(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return stft_ops.magphase(*self.forward(wav))

    def inverse(self, magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        return stft_ops.istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase),
                              self.n_fft, self.hop_length, self.win_length)

    __call__ = transform


class Audio2Mel:
    """MelGAN's log10 mel spectrogram."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, sampling_rate: int = 22050,
                 n_mel_channels: int = 80, mel_fmin: float = 0.0,
                 mel_fmax: float = None):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.sampling_rate = sampling_rate
        self.n_mel_channels = n_mel_channels
        self.mel_fmin = mel_fmin
        self.mel_fmax = mel_fmax

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        if audio.ndim == 3:    # (N, 1, T) -> (N, T)
            audio = audio.squeeze(1)
        return mel_ops.audio2mel(audio, self.n_fft, self.hop_length, self.win_length,
                                 self.sampling_rate, self.n_mel_channels, self.mel_fmin,
                                 self.mel_fmax)

    forward = __call__


class LogMelSpectrogramTorchAudio:
    """Power mel, log, clip: torchaudio's ``MelSpectrogram`` defaults, a power
    (magnitude²) spectrum of a centered Hann STFT and an HTK-scaled,
    unnormalized filterbank (``htk=True, norm=None``); ``htk=False,
    norm='slaney'`` gives the toolkit's Slaney filterbank."""

    def __init__(self, sample_rate: int, mel_size: int, n_fft: int, win_length: int,
                 hop_length: int, min_db: float, max_db: float,
                 mel_min: float = 0., mel_max: float = None,
                 htk: bool = True, norm: Optional[str] = None):
        self.sample_rate = sample_rate
        self.mel_size = mel_size
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.min_db = mel_ops.db_to_log(min_db)
        self.max_db = mel_ops.db_to_log(max_db)
        self.mel_min = mel_min
        self.mel_max = mel_max
        self.htk = htk
        self.norm = norm

    def __call__(self, wav: torch.Tensor, log_offset: float = 1e-6) -> torch.Tensor:
        mag = stft_ops.spectrogram_magnitude(wav, self.n_fft, self.hop_length,
                                             self.win_length, center=True)
        mel_filter = mel_ops.cached_mel_filter(
            self.sample_rate, self.n_fft, self.mel_size, self.mel_min, self.mel_max,
            htk=self.htk, norm=self.norm)
        mel = torch.matmul(device_constant(mel_filter, mag), mag * mag)
        return torch.clamp(torch.log(mel + log_offset), self.min_db, self.max_db)

    forward = __call__


class SpectrogramMasker:
    """Wave-level mask -> frame-level mask."""

    def __init__(self, win_length: int, hop_length: int):
        self.win_length = win_length
        self.hop_length = hop_length

    def __call__(self, wav_mask: torch.Tensor) -> torch.Tensor:
        return sound_ops.spectrogram_mask(wav_mask, self.win_length, self.hop_length)

    forward = __call__


class MelToMFCC:
    """log-mel -> MFCC by the DCT-II."""

    def __init__(self, n_mfcc: int, mel_size: int, norm: str = 'ortho'):
        self.n_mfcc = n_mfcc
        self.mel_size = mel_size
        self.norm = norm

    def __call__(self, mel_spec: torch.Tensor) -> torch.Tensor:
        assert mel_spec.ndim == 3
        return mel_ops.mel_to_mfcc(mel_spec, self.n_mfcc, self.mel_size, self.norm)

    forward = __call__


class MFCC:
    """Wave (N, 1, T) -> MFCC (N, 1, n_mfcc, T'), the log-mel through
    :class:`LogMelSpectrogram` (so on the fused geometry through K2)."""

    def __init__(self, sample_rate: int, mel_size: int, n_fft: int, win_length: int,
                 n_mfcc: int, hop_length: int, min_db: float, max_db: float,
                 mel_min: float = 0., mel_max: float = None, norm: str = 'ortho'):
        self.n_mfcc = n_mfcc
        self.mel_func = LogMelSpectrogram(
            sample_rate, mel_size, n_fft, win_length, hop_length, min_db, max_db,
            mel_min, mel_max)
        self.mel_size = mel_size
        self.norm = norm

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        assert wav.ndim == 3
        return mel_ops.mel_to_mfcc(self.mel_func(wav), self.n_mfcc, self.mel_size, self.norm)

    forward = __call__


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.15,
                            beta: float = 9.0) -> np.ndarray:
    """The PQMF's Kaiser prototype."""
    return filters.pqmf_prototype(taps, cutoff_ratio, beta)


class PQMF:
    """Near-perfect-reconstruction pseudo-QMF bank."""

    def __init__(self, subbands: int = 4, taps: int = 62,
                 cutoff_ratio: float = 0.15, beta: float = 9.0):
        self.subbands = subbands
        self.taps = taps
        self.cutoff_ratio = cutoff_ratio
        self.beta = beta

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, T) -> (B, subbands, T // subbands)."""
        return pqmf_ops.analysis(x, self.subbands, self.taps, self.cutoff_ratio, self.beta)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, subbands, T // subbands) -> (B, 1, T)."""
        return pqmf_ops.synthesis(x, self.subbands, self.taps, self.cutoff_ratio, self.beta)
