"""HiFi-GAN critics (multi-period + multi-scale) in PyTorch.

Counterpart of ``pytorch_sound_tpu/models/vocoders/discriminators.py``: the
paper's (arXiv 2010.05646) MPD / MSD with weight-normed convs, the same
registry names and the same parameter tree (``period_2.conv_0.v``,
``scale_1.conv_post.bias``). Each sub-discriminator returns
``(score (N, -1), [feature maps])`` for the LSGAN and feature-matching losses
(``ops/gan.py``).

Layout: the port keeps features channels-first. A period discriminator's maps
are (N, P, C, H) where the JAX package's are (N, P, H, C), a scale
discriminator's (N, C, T) where JAX's are (N, T, C); the scores have the JAX
order. The losses are element-wise means, so the layout is free.

Each conv takes its backend from ``backends``, one entry per layer (the body
layers, then conv_post), as in the JAX package: ``'cudnn'`` (the default,
``F.conv1d``, as the JAX defaults leave the convs to XLA) or ``'cuda'``, the
grouped-conv kernels (K6) for forward, dx and dw with the leaky_relu fused
into the forward (JAX ``'pallas'``). ``msd_apply_folded`` and bf16 critics
are not ported yet.
"""

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_sound_tpu_torch.models import register_model, register_model_architecture
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import WNConv1d

SLOPE = 0.1
PERIOD_LAYERS = 6         # 5 body layers + conv_post (JAX PeriodDiscriminator.backends)
SCALE_LAYERS = 8          # 7 body layers + conv_post (JAX ScaleDiscriminator.backends)
DiscOut = Tuple[torch.Tensor, List[torch.Tensor]]


def _layer_backends(backends: Sequence[str], n: int) -> Tuple[str, ...]:
    """The backends of n conv layers, the body layers then conv_post: the
    first n entries, as the JAX critics index theirs (a period stack with
    fewer channels uses the first of its 6)."""
    if len(backends) < n:
        raise ValueError('%d conv layers need %d backends, got %r' % (n, n, backends))
    return tuple(backends[:n])


class PeriodDiscriminator(nn.Module):
    """Folds the wave into (T / period, period) and runs a (5, 1)-conv stack.

    The paper's 2-D convs have kernel and stride 1 along the period axis, so
    every period column is convolved on its own: the period is folded into
    the batch once and the stack runs as conv1d's, the JAX package's
    formulation.
    """

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Sequence[int] = (32, 128, 512, 1024),
                 backends: Sequence[str] = ('cudnn',) * PERIOD_LAYERS):
        super().__init__()
        self.period = period
        self.n_layers = len(channels) + 1
        backends = _layer_backends(backends, self.n_layers + 1)
        kpad = (kernel_size - 1) // 2
        in_ch = 1
        for i, ch in enumerate(channels):
            self.add_module('conv_%d' % i, WNConv1d(
                in_ch, ch, kernel_size, stride=stride, padding=kpad,
                fused_slope=SLOPE, backend=backends[i]))
            in_ch = ch
        self.add_module('conv_%d' % len(channels), WNConv1d(
            in_ch, channels[-1], kernel_size, padding=kpad, fused_slope=SLOPE,
            backend=backends[len(channels)]))
        self.conv_post = WNConv1d(channels[-1], 1, 3, padding=1, backend=backends[-1])

    def forward(self, x: torch.Tensor) -> DiscOut:
        n, c, t = x.shape
        pad = (-t) % self.period
        if pad:
            x = F.pad(x, (0, pad), mode='reflect')
        h = (t + pad) // self.period
        # (N, C, H, P) -> (N, P, C, H) -> (N*P, C, H): period into batch
        x = x.reshape(n, c, h, self.period).permute(0, 3, 1, 2) \
             .reshape(n * self.period, c, h)

        def feat(y):
            # leading dim is the true batch: the batched real+fake pass
            # slices feature maps along dim 0
            return y.reshape(n, self.period, y.shape[1], y.shape[2])

        features = []
        for i in range(self.n_layers):
            x = getattr(self, 'conv_%d' % i)(x)
            features.append(feat(x))
        x = self.conv_post(x)
        features.append(feat(x))
        return x.reshape(n, -1), features        # score in (period, time) order


def scale_disc_layout(width: float) -> List[Tuple[int, int, int, int, int, int]]:
    """Per-layer (in, out, kernel, stride, groups, padding) of the paper's
    scale-discriminator body at a channel-width multiplier."""
    def w(ch):
        return max(8, int(ch * width))
    return [
        (1, w(128), 15, 1, 1, 7),
        (w(128), w(128), 41, 2, 4, 20),
        (w(128), w(256), 41, 2, 8, 20),
        (w(256), w(512), 41, 4, 8, 20),
        (w(512), w(1024), 41, 4, 8, 20),
        (w(1024), w(1024), 41, 1, 8, 20),
        (w(1024), w(1024), 5, 1, 1, 2),
    ]


class ScaleDiscriminator(nn.Module):
    """Grouped long-kernel conv1d stack over the raw wave; ``width`` scales
    the channel counts (1.0 = the paper's 128..1024 stack)."""

    def __init__(self, width: float = 1.0,
                 backends: Sequence[str] = ('cudnn',) * SCALE_LAYERS):
        super().__init__()
        layout = scale_disc_layout(width)
        self.n_layers = len(layout)
        backends = _layer_backends(backends, self.n_layers + 1)
        for i, (ic, oc, k, s, g, p) in enumerate(layout):
            self.add_module('conv_%d' % i, WNConv1d(
                ic, oc, k, stride=s, padding=p, groups=g, fused_slope=SLOPE,
                backend=backends[i]))
        self.conv_post = WNConv1d(layout[-1][1], 1, 3, padding=1, backend=backends[-1])

    def forward(self, x: torch.Tensor) -> DiscOut:
        features = []
        for i in range(self.n_layers):
            x = getattr(self, 'conv_%d' % i)(x)
            features.append(x)
        x = self.conv_post(x)
        features.append(x)
        return x.reshape(x.shape[0], -1), features


@register_model('hifi_gan_mpd')
class MultiPeriodDiscriminator(nn.Module):
    """Period discriminators at the paper's prime periods."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 channels: Sequence[int] = (32, 128, 512, 1024),
                 backends: Sequence[str] = ('cudnn',) * PERIOD_LAYERS):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module('period_%d' % p, PeriodDiscriminator(
                p, channels=channels, backends=backends))

    def forward(self, x: torch.Tensor) -> List[DiscOut]:
        return [getattr(self, 'period_%d' % p)(x) for p in self.periods]


@register_model('hifi_gan_msd')
class MultiScaleDiscriminator(nn.Module):
    """Scale discriminators on the wave and its average-pooled octaves."""

    def __init__(self, n_scales: int = 3, width: float = 1.0,
                 backends: Sequence[str] = ('cudnn',) * SCALE_LAYERS):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            self.add_module('scale_%d' % i, ScaleDiscriminator(width, backends))

    def forward(self, x: torch.Tensor) -> List[DiscOut]:
        outs = []
        for i in range(self.n_scales):
            if i > 0:
                # flax's avg_pool counts the zero padding in the divisor
                x = F.avg_pool1d(x, 4, stride=2, padding=2, count_include_pad=True)
            outs.append(getattr(self, 'scale_%d' % i)(x))
        return outs


@register_model_architecture('hifi_gan_mpd', 'hifi_gan_mpd_base')
def hifi_gan_mpd_base():
    return {'periods': (2, 3, 5, 7, 11), 'channels': (32, 128, 512, 1024),
            'backends': ('cudnn',) * PERIOD_LAYERS}


@register_model_architecture('hifi_gan_mpd', 'hifi_gan_mpd_small')
def hifi_gan_mpd_small():
    return {'periods': (2, 3), 'channels': (8, 16), 'backends': ('cudnn',) * PERIOD_LAYERS}


@register_model_architecture('hifi_gan_msd', 'hifi_gan_msd_base')
def hifi_gan_msd_base():
    return {'n_scales': 3, 'width': 1.0, 'backends': ('cudnn',) * SCALE_LAYERS}


@register_model_architecture('hifi_gan_msd', 'hifi_gan_msd_small')
def hifi_gan_msd_small():
    return {'n_scales': 2, 'width': 0.0625, 'backends': ('cudnn',) * SCALE_LAYERS}
