"""Spectrogram-masking speech enhancement network.

Counterpart of ``pytorch_sound_tpu/models/enhancement.py``, the model of the
VoiceBank enhancement recipe: a conv stack over log-compressed STFT
magnitudes that predicts a sigmoid mask. What the flax module does, kept
here:

- ``nn.gelu`` is the tanh approximation: ``F.gelu(approximate='tanh')``;
- ``nn.LayerNorm`` has eps 1e-6 (torch's default is 1e-5), over channels;
- ``nn.Conv`` pads 'SAME' and holds its kernel as (k, in, out), a Conv1d
  weight (out, in, k) here (:func:`spec_masker_from_jax` carries one over);
- the flax model works in (N, T, F) and transposes back at the end; here the
  convs run channels-first on (N, F, T) and the LayerNorm on the transposed
  view, which is the same function.

Parameter names are the flax ones (``conv_in``, ``ln_i``, ``conv_ai``,
``conv_bi``, ``conv_out``). Initialisation follows flax's defaults:
LeCun-normal kernels (truncated at two standard deviations), zero biases,
unit LayerNorm scales.
"""

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_sound_tpu_torch.models import register_model, register_model_architecture
from pytorch_sound_tpu_torch.models.modules import LAYERNORM_EPS, load_jax_params


def _lecun_conv(c_in: int, c_out: int, k: int) -> nn.Conv1d:
    conv = nn.Conv1d(c_in, c_out, k, padding='same')
    std = np.sqrt(1.0 / (c_in * k)) / .87962566103423978    # flax's truncation factor
    nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(conv.bias)
    return conv


@register_model('spec_masker')
class SpectrogramMaskNet(nn.Module):
    """Magnitude (N, F, T) -> sigmoid mask (N, F, T)."""

    def __init__(self, spec_size: int = 513, hidden_dim: int = 256, n_blocks: int = 4,
                 kernel_size: int = 5):
        super().__init__()
        self.n_blocks = n_blocks
        self.conv_in = _lecun_conv(spec_size, hidden_dim, kernel_size)
        for i in range(n_blocks):
            self.add_module('ln_%d' % i, nn.LayerNorm(hidden_dim, eps=LAYERNORM_EPS))
            self.add_module('conv_a%d' % i, _lecun_conv(hidden_dim, hidden_dim, kernel_size))
            self.add_module('conv_b%d' % i, _lecun_conv(hidden_dim, hidden_dim, 1))
        self.conv_out = _lecun_conv(hidden_dim, spec_size, 1)

    def forward(self, mag: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(torch.log1p(mag))                      # (N, hidden, T)
        for i in range(self.n_blocks):
            h = getattr(self, 'ln_%d' % i)(x.transpose(1, 2)).transpose(1, 2)
            h = F.gelu(getattr(self, 'conv_a%d' % i)(h), approximate='tanh')
            x = x + getattr(self, 'conv_b%d' % i)(h)            # residual
        return torch.sigmoid(self.conv_out(x))


@register_model_architecture('spec_masker', 'spec_masker_base')
def spec_masker_base():
    return {'spec_size': 513, 'hidden_dim': 256, 'n_blocks': 4, 'kernel_size': 5}


@register_model_architecture('spec_masker', 'spec_masker_small')
def spec_masker_small():
    return {'spec_size': 513, 'hidden_dim': 96, 'n_blocks': 2, 'kernel_size': 3}


def spec_masker_from_jax(tree: Dict[str, Any]) -> SpectrogramMaskNet:
    """The port's :class:`SpectrogramMaskNet` holding a JAX ``spec_masker``
    parameter tree (numpy arrays, with or without the 'params' key); its
    configuration is read from the kernels' shapes."""
    params = tree.get('params', tree)
    k, spec_size, hidden = np.shape(params['conv_in']['kernel'])
    n_blocks = sum(1 for name in params if name.startswith('ln_'))
    return load_jax_params(SpectrogramMaskNet(spec_size, hidden, n_blocks, k), tree)
