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
into the forward (JAX ``'pallas'``).

Precision: every critic conv takes ``precision`` and ``compute_dtype``
(:func:`~pytorch_sound_tpu_torch.models.vocoders.hifi_gan.conv1d_route`).
The JAX critics default to ``precision='default'`` (each operand rounded to
bf16, fp32 sums: K6's bf16 tensor-core products, cuDNN's fp32 convolution
of the rounded operands);
the port defaults to ``'highest'`` (fp32-accurate) and runs 'default' on
request. ``compute_dtype='bf16'`` runs the critics on bfloat16 activations
and bf16 copies of the fp32 weights; the gradients reach the fp32 parameters.

:func:`msd_apply_folded` runs a MultiScaleDiscriminator as one block-diagonal
grouped stack over its scales (8 convs instead of 24), the JAX package's
formulation, from the same parameters.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_sound_tpu_torch.models import register_model, register_model_architecture
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import (_WNConv, WNConv1d,
                                                              check_compute_dtype,
                                                              conv1d_route, rounded_conv)
from pytorch_sound_tpu_torch.ops.cuda.grouped_conv import check_precision

SLOPE = 0.1
PERIOD_LAYERS = 6         # 5 body layers + conv_post (JAX PeriodDiscriminator.backends)
SCALE_LAYERS = 8          # 7 body layers + conv_post (JAX ScaleDiscriminator.backends)
DiscOut = Tuple[torch.Tensor, List[torch.Tensor]]


class WNConv2d(_WNConv):
    """Conv2d with torch-style weight normalization (dim 0), NCHW; weight
    (C_out, C_in, kh, kw) (JAX ``WNConv2d``: ``v`` in the same OIHW layout,
    so ``load_jax_params`` takes it as it stands). ``F.conv2d`` in fp32 at
    ``precision='highest'``; in 'default' the fp32 conv of the bf16-rounded
    operands (:func:`~pytorch_sound_tpu_torch.models.vocoders.hifi_gan.
    rounded_conv`); with ``compute_dtype='bf16'`` cuDNN's bf16 convolution
    (which returns bfloat16), the bias added in fp32 to its output, as
    :func:`conv1d_route`'s cuDNN route."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0),
                 use_weight_norm: bool = True, precision: str = 'highest',
                 compute_dtype: Optional[str] = None):
        super().__init__((out_channels, in_channels) + tuple(kernel_size), out_channels,
                         use_weight_norm)
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.precision = check_precision(precision)
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, conf = self.folded_weight(), dict(stride=self.stride, padding=self.padding)
        if self.compute_dtype == 'bf16':
            out = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), None, **conf)
            return (out.float() + self.bias[None, :, None, None]).to(torch.bfloat16)
        if self.precision == 'default':
            return rounded_conv(x, w, self.bias, **conf)
        return F.conv2d(x, w, self.bias, **conf)


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
                 backends: Sequence[str] = ('cudnn',) * PERIOD_LAYERS,
                 precision: str = 'highest', compute_dtype: Optional[str] = None):
        super().__init__()
        self.period = period
        self.n_layers = len(channels) + 1
        backends = _layer_backends(backends, self.n_layers + 1)
        mode = dict(precision=precision, compute_dtype=compute_dtype)
        kpad = (kernel_size - 1) // 2
        in_ch = 1
        for i, ch in enumerate(channels):
            self.add_module('conv_%d' % i, WNConv1d(
                in_ch, ch, kernel_size, stride=stride, padding=kpad,
                fused_slope=SLOPE, backend=backends[i], **mode))
            in_ch = ch
        self.add_module('conv_%d' % len(channels), WNConv1d(
            in_ch, channels[-1], kernel_size, padding=kpad, fused_slope=SLOPE,
            backend=backends[len(channels)], **mode))
        self.conv_post = WNConv1d(channels[-1], 1, 3, padding=1, backend=backends[-1], **mode)

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
                 backends: Sequence[str] = ('cudnn',) * SCALE_LAYERS,
                 precision: str = 'highest', compute_dtype: Optional[str] = None):
        super().__init__()
        layout = scale_disc_layout(width)
        self.n_layers = len(layout)
        backends = _layer_backends(backends, self.n_layers + 1)
        mode = dict(precision=precision, compute_dtype=compute_dtype)
        for i, (ic, oc, k, s, g, p) in enumerate(layout):
            self.add_module('conv_%d' % i, WNConv1d(
                ic, oc, k, stride=s, padding=p, groups=g, fused_slope=SLOPE,
                backend=backends[i], **mode))
        self.conv_post = WNConv1d(layout[-1][1], 1, 3, padding=1, backend=backends[-1],
                                  **mode)

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
                 backends: Sequence[str] = ('cudnn',) * PERIOD_LAYERS,
                 precision: str = 'highest', compute_dtype: Optional[str] = None):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module('period_%d' % p, PeriodDiscriminator(
                p, channels=channels, backends=backends, precision=precision,
                compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor) -> List[DiscOut]:
        return [getattr(self, 'period_%d' % p)(x) for p in self.periods]


@register_model('hifi_gan_msd')
class MultiScaleDiscriminator(nn.Module):
    """Scale discriminators on the wave and its average-pooled octaves."""

    def __init__(self, n_scales: int = 3, width: float = 1.0,
                 backends: Sequence[str] = ('cudnn',) * SCALE_LAYERS,
                 precision: str = 'highest', compute_dtype: Optional[str] = None):
        super().__init__()
        self.n_scales, self.width = n_scales, width
        for i in range(n_scales):
            self.add_module('scale_%d' % i, ScaleDiscriminator(
                width, backends, precision=precision, compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor) -> List[DiscOut]:
        outs = []
        for i in range(self.n_scales):
            if i > 0:
                x = _pool(x)
            outs.append(getattr(self, 'scale_%d' % i)(x))
        return outs


def _pool(x: torch.Tensor) -> torch.Tensor:
    """The MSD's octave pooling; flax's avg_pool counts the zero padding in
    the divisor."""
    return F.avg_pool1d(x, 4, stride=2, padding=2, count_include_pad=True)


def _msd_valid_lengths(t: int, n_scales: int) -> List[int]:
    """Valid sample count of each MSD scale (avg_pool k=4 s=2 pad (2,2))."""
    lens = [t]
    for _ in range(n_scales - 1):
        lens.append((lens[-1] + 4 - 4) // 2 + 1)
    return lens


def msd_apply_folded(msd: MultiScaleDiscriminator, x: torch.Tensor) -> List[DiscOut]:
    """Run ``msd`` as one block-diagonal grouped stack over all its scales:
    the same function, parameters and ``[(score, features)]`` as ``msd(x)``,
    in 8 convs instead of 3 x 8 (JAX ``msd_apply_folded``).

    The pooled scales are zero-padded to the wave's length and stacked on
    the channel axis; each layer is one grouped conv with n_scales x groups
    groups over the scales' weight-normed weights concatenated (group u of
    scale s reads only scale s's channels), on the backend, precision and
    compute dtype of that layer in the MSD (``scale_0.conv_i``). The padded
    tails are zeroed after every layer, so the bias does not leak into them
    and they add nothing to dw or db: every valid position reads what the
    unfolded conv reads, its samples or zeros. The JAX package also
    dense-expands the narrow layers (cin / groups <= 32) to fill the TPU's
    matrix unit; here those run as the plain block-diagonal grouped conv,
    without the expansion's zero products.
    """
    n, _, t = x.shape
    n_scales = msd.n_scales
    layout = scale_disc_layout(msd.width)
    scales = [getattr(msd, 'scale_%d' % s) for s in range(n_scales)]
    lens = _msd_valid_lengths(t, n_scales)
    xs, cur = [], x
    for s in range(n_scales):
        if s > 0:
            cur = _pool(cur)
        xs.append(F.pad(cur, (0, t - cur.shape[2])))
    h = torch.cat(xs, dim=1)                             # (N, n_scales, T)
    features: List[List[torch.Tensor]] = [[] for _ in range(n_scales)]
    names = ['conv_%d' % i for i in range(len(layout))] + ['conv_post']
    for name in names:
        convs = [getattr(sc, name) for sc in scales]
        w = torch.cat([c.folded_weight() for c in convs], dim=0)
        b = torch.cat([c.bias for c in convs], dim=0)
        h = conv1d_route(h, w, b, groups=n_scales * convs[0].groups, **convs[0].route())
        oc = convs[0].out_channels
        lens = [(l + 2 * convs[0].padding - convs[0].kernel_size) // convs[0].stride + 1
                for l in lens]
        keep = torch.zeros((n_scales, 1, h.shape[2]), dtype=h.dtype, device=h.device)
        for s, l in enumerate(lens):
            keep[s, :, :l] = 1
        h = (h.reshape(n, n_scales, oc, h.shape[2]) * keep).reshape(h.shape)
        for s, l in enumerate(lens):
            features[s].append(h[:, s * oc:(s + 1) * oc, :l])
    return [(feats[-1].reshape(n, -1), feats) for feats in features]


# every architecture's critics at the port's default precision, fp32; a
# caller asks for the JAX defaults with extra_kwargs={'precision': 'default'}
# (and compute_dtype='bf16' for bf16 critics)
MODE = {'precision': 'highest', 'compute_dtype': None}


@register_model_architecture('hifi_gan_mpd', 'hifi_gan_mpd_base')
def hifi_gan_mpd_base():
    return {'periods': (2, 3, 5, 7, 11), 'channels': (32, 128, 512, 1024),
            'backends': ('cudnn',) * PERIOD_LAYERS, **MODE}


@register_model_architecture('hifi_gan_mpd', 'hifi_gan_mpd_small')
def hifi_gan_mpd_small():
    return {'periods': (2, 3), 'channels': (8, 16), 'backends': ('cudnn',) * PERIOD_LAYERS,
            **MODE}


@register_model_architecture('hifi_gan_msd', 'hifi_gan_msd_base')
def hifi_gan_msd_base():
    return {'n_scales': 3, 'width': 1.0, 'backends': ('cudnn',) * SCALE_LAYERS, **MODE}


@register_model_architecture('hifi_gan_msd', 'hifi_gan_msd_small')
def hifi_gan_msd_small():
    return {'n_scales': 2, 'width': 0.0625, 'backends': ('cudnn',) * SCALE_LAYERS, **MODE}
