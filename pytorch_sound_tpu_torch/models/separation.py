"""U-Net magnitude-STFT masking network for source separation.

Counterpart of ``pytorch_sound_tpu/models/separation.py``, the model of the
DSD100 / MUSDB18 / MedleyDB separation recipe: a 2-D conv U-Net over
log1p-compressed (freq, time) magnitudes that predicts a sigmoid mask. The
flax module works in NHWC with (F, T) as the spatial axes; here the convs
run in NCHW on the same axes, which is the same function. What the flax
layers do, kept here:

- ``Conv((4, 4), strides=2, 'SAME')`` on an even size pads (1, 1):
  ``Conv2d(k=4, s=2, padding=1)``;
- ``ConvTranspose((4, 4), strides=2, 'SAME')`` correlates the
  stride-dilated input, padded (2, 2), with its kernel as it stands: that is
  ``ConvTranspose2d(k=4, s=2, padding=1)`` with the kernel flipped in space,
  which :func:`~pytorch_sound_tpu_torch.models.modules.load_jax_params`
  does when it carries a flax tree over;
- ``GroupNorm(num_groups=min(8, C))`` has eps 1e-6 (torch's default is
  1e-5) and normalises over (F, T, the channels of a group), as torch's
  GroupNorm does on NCHW;
- the final ``Conv((3, 3), 'SAME')`` pads 1, ``Conv((1, 1))`` none;
- the input is padded at the end of F and T to a multiple of 2^depth and
  the mask sliced back to (F, T).

Submodules carry the flax auto-names (``_DownBlock_i``, ``_UpBlock_i``,
``ConvTranspose_0``, ``Conv_0``, ``Conv_1``; in a block ``Conv_0`` or
``ConvTranspose_0`` and ``GroupNorm_0``). Initialisation follows flax's
defaults: LeCun-normal kernels (truncated at two standard deviations, fan-in
over the kernel's input channels and taps), zero biases, unit GroupNorm
scales.
"""

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_sound_tpu_torch.models import register_model, register_model_architecture

GROUPNORM_EPS = 1e-6     # flax nn.GroupNorm's default


def _lecun(conv: nn.Module, fan_in: int) -> nn.Module:
    std = np.sqrt(1.0 / fan_in) / .87962566103423978    # flax's truncation factor
    nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(conv.bias)
    return conv


def _conv(c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return _lecun(nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding), c_in * k * k)


def _up_conv(c_in: int, c_out: int) -> nn.ConvTranspose2d:
    """flax ``ConvTranspose(c_out, (4, 4), strides=(2, 2), padding='SAME')``."""
    return _lecun(nn.ConvTranspose2d(c_in, c_out, 4, stride=2, padding=1), c_in * 16)


class _DownBlock(nn.Module):
    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.Conv_0 = _conv(c_in, features, 4, stride=2, padding=1)
        self.GroupNorm_0 = nn.GroupNorm(min(8, features), features, eps=GROUPNORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.GroupNorm_0(self.Conv_0(x)), 0.2)


class _UpBlock(nn.Module):
    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = _up_conv(c_in, features)
        self.GroupNorm_0 = nn.GroupNorm(min(8, features), features, eps=GROUPNORM_EPS)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.ConvTranspose_0(x)))
        return torch.cat([x, skip], dim=1)


@register_model('spec_unet')
class SpectrogramUNet(nn.Module):
    """Magnitude (N, F, T) -> sigmoid source mask (N, F, T)."""

    def __init__(self, channels: Sequence[int] = (16, 32, 64, 128), spec_size: int = 513):
        super().__init__()
        self.channels = tuple(channels)
        self.spec_size = spec_size
        c_in = 1
        for i, ch in enumerate(self.channels):
            self.add_module('_DownBlock_%d' % i, _DownBlock(c_in, ch))
            c_in = ch
        # an up block's output: its features and the skip's (the down
        # block's output one level up), concatenated
        for i, ch in enumerate(reversed(self.channels[:-1])):
            self.add_module('_UpBlock_%d' % i, _UpBlock(c_in, ch))
            c_in = 2 * ch
        self.ConvTranspose_0 = _up_conv(c_in, self.channels[0])
        self.Conv_0 = _conv(self.channels[0] + 1, self.channels[0], 3, padding=1)
        self.Conv_1 = _conv(self.channels[0], 1, 1)

    def forward(self, mag: torch.Tensor) -> torch.Tensor:
        depth = len(self.channels)
        scale = 2 ** depth
        n, f, t = mag.shape
        # pad freq / time up to the stride pyramid; slice back at the end
        x = F.pad(torch.log1p(mag)[:, None], (0, (-t) % scale, 0, (-f) % scale))
        skips = []
        for i in range(depth):
            skips.append(x)
            x = getattr(self, '_DownBlock_%d' % i)(x)
        for i in range(depth - 1):
            x = getattr(self, '_UpBlock_%d' % i)(x, skips.pop())
        x = torch.cat([self.ConvTranspose_0(x), skips.pop()], dim=1)
        x = F.relu(self.Conv_0(x))
        mask = self.Conv_1(x)[:, 0]                         # (N, F + pad, T + pad)
        return torch.sigmoid(mask)[:, :f, :t]


@register_model_architecture('spec_unet', 'spec_unet_base')
def spec_unet_base():
    return {'channels': (16, 32, 64, 128), 'spec_size': 513}


@register_model_architecture('spec_unet', 'spec_unet_small')
def spec_unet_small():
    return {'channels': (8, 16, 32), 'spec_size': 513}
