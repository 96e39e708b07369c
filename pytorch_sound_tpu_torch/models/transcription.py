"""Frame-level piano transcription network for the Maestro recipe.

Counterpart of ``pytorch_sound_tpu/models/transcription.py``: log-mel frames
-> a dilated conv stack -> per-frame logits of 128 pitches, trained against
the piano roll. The flax module works in (N, T, M); here the convs run
channels-first on (N, M, T) and the LayerNorm and the head on the
transposed view, which is the same function. Kept from flax:

- ``Conv`` pads 'SAME': kernel 3 at dilation 2^i pads 2^i on each side;
- ``nn.LayerNorm`` has eps 1e-6 (torch's default is 1e-5);
- ``nn.gelu`` is the tanh approximation.

Parameter names are the flax ones (``conv_in``, ``ln_i``, ``conv_ai``,
``conv_bi``, ``head``). Initialisation follows flax's defaults: LeCun-normal
kernels (truncated at two standard deviations), zero biases, unit LayerNorm
scales.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_sound_tpu_torch.models import register_model, register_model_architecture
from pytorch_sound_tpu_torch.models.modules import LAYERNORM_EPS


def _lecun(layer: nn.Module, fan_in: int) -> nn.Module:
    std = np.sqrt(1.0 / fan_in) / .87962566103423978    # flax's truncation factor
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(layer.bias)
    return layer


def _conv(c_in: int, c_out: int, k: int, dilation: int = 1) -> nn.Conv1d:
    return _lecun(nn.Conv1d(c_in, c_out, k, dilation=dilation, padding='same'), c_in * k)


@register_model('frame_pitch')
class FramePitchNet(nn.Module):
    """log-mel (N, M, T) -> pitch logits (N, 128, T)."""

    def __init__(self, mel_size: int = 80, hidden_dim: int = 256, n_blocks: int = 4,
                 kernel_size: int = 3, n_pitches: int = 128):
        super().__init__()
        self.n_blocks = n_blocks
        self.conv_in = _conv(mel_size, hidden_dim, kernel_size)
        for i in range(n_blocks):
            self.add_module('ln_%d' % i, nn.LayerNorm(hidden_dim, eps=LAYERNORM_EPS))
            # growing dilation: context over frames without downsampling
            self.add_module('conv_a%d' % i, _conv(hidden_dim, hidden_dim, kernel_size, 2 ** i))
            self.add_module('conv_b%d' % i, _conv(hidden_dim, hidden_dim, 1))
        self.head = _lecun(nn.Linear(hidden_dim, n_pitches), hidden_dim)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(mel)                                   # (N, hidden, T)
        for i in range(self.n_blocks):
            h = getattr(self, 'ln_%d' % i)(x.transpose(1, 2)).transpose(1, 2)
            h = F.gelu(getattr(self, 'conv_a%d' % i)(h), approximate='tanh')
            x = x + getattr(self, 'conv_b%d' % i)(h)            # residual
        return self.head(x.transpose(1, 2)).transpose(1, 2)     # (N, 128, T)


@register_model_architecture('frame_pitch', 'frame_pitch_base')
def frame_pitch_base():
    return {'mel_size': 80, 'hidden_dim': 256, 'n_blocks': 4, 'kernel_size': 3}


@register_model_architecture('frame_pitch', 'frame_pitch_small')
def frame_pitch_small():
    return {'mel_size': 80, 'hidden_dim': 96, 'n_blocks': 2, 'kernel_size': 3}
