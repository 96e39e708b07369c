"""Wave-level modules: windowed volume norm, the pre-emphasis pair, the
multi-resolution STFT loss.

Counterpart of ``pytorch_sound_tpu/models/sound.py``, over
:mod:`pytorch_sound_tpu_torch.ops.sound`.
"""

from typing import List, Tuple

import torch

from pytorch_sound_tpu_torch.models.transforms import STFTTorchAudio as STFT
from pytorch_sound_tpu_torch.ops import sound as sound_ops


class VolNormConv:
    """Windowed (hop-wise) volume normalization; ``reverse`` undoes it with
    the per-hop stds of the last ``forward``."""

    def __init__(self, window_size: int, hop_size: int, target_db: float):
        self.window_size = window_size
        self.hop_size = hop_size
        self.target_db = target_db
        self.prev_wav_len = -1
        self.std_buffer = None

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        self.prev_wav_len = wav.shape[-1]
        normed, self.std_buffer = sound_ops.windowed_volume_norm(
            wav, self.window_size, self.hop_size, self.target_db)
        return normed

    def reverse(self, wav: torch.Tensor) -> torch.Tensor:
        assert self.prev_wav_len >= wav.shape[-1], \
            '{} is smaller than {} !'.format(self.prev_wav_len, wav.shape[-1])
        return sound_ops.windowed_volume_reverse(
            wav, self.std_buffer, self.window_size, self.hop_size, self.target_db)

    __call__ = forward


class PreEmphasis:
    """FIR pre-emphasis on (N, 1, T)."""

    def __init__(self, coef: float = 0.97):
        self.coef = coef

    def __call__(self, input: torch.Tensor) -> torch.Tensor:
        assert input.ndim == 3, 'The number of dimensions of input tensor must be 3!'
        return sound_ops.preemphasis(input, self.coef)

    forward = __call__


class InversePreEmphasis:
    """Inverse pre-emphasis IIR on (N, 1, T), from a zero state
    (:func:`~pytorch_sound_tpu_torch.ops.sound.inv_preemphasis`)."""

    def __init__(self, coef: float = 0.97):
        self.coef = coef

    def __call__(self, input: torch.Tensor) -> torch.Tensor:
        return sound_ops.inv_preemphasis(input, self.coef)

    forward = __call__


def build_stft_functions(*params: Tuple[int, int, int]) -> List[STFT]:
    """STFT modules for the given (n_fft, win, hop) triples."""
    return [STFT(win, hop, win, fft) for fft, win, hop in params]


def multi_stft_loss(pred: torch.Tensor, target: torch.Tensor,
                    stft_params: List[Tuple[int, int, int]], eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-resolution STFT loss: (total, spectral convergence, log
    magnitude)."""
    return sound_ops.multi_stft_loss(pred, target, stft_params, eps)
