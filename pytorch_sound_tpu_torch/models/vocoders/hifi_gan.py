"""HiFi-GAN generator (arXiv 2010.05646) in PyTorch, training and inference.

Counterpart of ``pytorch_sound_tpu/models/vocoders/hifi_gan.py``: the same
architecture registry names (hifi_gan_v1/v2/v3), conv geometry and weight
normalization. The state-dict keys are the JAX parameter tree's paths joined
with '.' in the same torch layouts: ``conv_pre.v`` / ``conv_pre.g`` /
``conv_pre.bias`` with weight norm (``use_weight_norm=True``, the default, as
in the JAX archs), ``conv_pre.weight`` / ``conv_pre.bias`` folded. The bundled
flax checkpoint (folded) and the JAX trainer's (g, v) trees load through
:func:`load_jax_params`.

Two forward paths, split as the JAX package splits them:

- :meth:`Generator.forward` runs layer by layer (cuDNN ``F.conv1d`` /
  ``F.conv_transpose1d`` on the card, or the grouped-conv kernels with
  ``backend='cuda'`` / ``ups_backend='cuda'``), in ``precision`` 'highest'
  or 'default', and is differentiable: the training path, as JAX
  ``Generator.__call__`` (whose NTC layout, the JAX recipe's, runs every
  conv in 'default').
- :func:`generator_apply_fused` is the inference path of the interface: with
  ResBlock1 (v1, v2) every upsample stage runs as one
  :func:`~pytorch_sound_tpu_torch.ops.cuda.gen_stage.generator_stage` call,
  the fused CUDA kernel on the card and its plain version on the CPU
  (``conv_pre`` folded into v1's 256-channel stage 0). With
  ``full_stage=False`` the upsamples run through ``F.conv_transpose1d`` and
  each stage's resblock mean through
  :func:`~pytorch_sound_tpu_torch.ops.cuda.gen_stage.resblock_stage`.
"""

import contextlib
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_sound_tpu_torch.models import register_model, register_model_architecture
from pytorch_sound_tpu_torch.ops.cuda.gen_stage import (check_mode, generator_stage,
                                                        get_padding, resblock_stage)
from pytorch_sound_tpu_torch.ops.cuda.grouped_conv import (check_precision, conv_transpose1d,
                                                            grouped_conv1d)
from pytorch_sound_tpu_torch.utils.checkpoint import tree_to_state_dict

INIT_STD = 0.01           # the JAX package's kernel init, N(0, 0.01)
BACKENDS = ('cudnn', 'cuda')    # F.conv1d / the grouped-conv kernels (K6)
COMPUTE_DTYPES = (None, 'bf16')


def weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``g * v / sqrt(sum(v², all dims but 0) + 1e-12)``, the JAX formula
    (``torch.nn.utils.weight_norm`` has no 1e-12 and other parameter names)."""
    dims = tuple(range(1, v.ndim))
    return g * v / torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12)


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError('conv backend must be one of %s, got %r' % (BACKENDS, backend))
    return backend


def check_compute_dtype(compute_dtype: Optional[str]) -> Optional[str]:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError('compute_dtype must be one of %s, got %r'
                         % (COMPUTE_DTYPES, compute_dtype))
    return compute_dtype


@contextlib.contextmanager
def _cudnn_tf32_off():
    """cuDNN's TF32 off for the calls inside, then restored. A bf16 value is
    exact in TF32, but with TF32 allowed cuDNN's forward missed the mode on
    the critics' convs (1.74e-5 of the max against a bound of 1e-5, on an
    NVIDIA H100 80GB HBM3 at 700 W) and ran no faster on the generator."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _RoundedConv(torch.autograd.Function):
    """cuDNN's convolution (``aten.convolution``: conv1d, conv2d or a
    transposed conv) in precision 'default' on float32 tensors: the fp32
    convolution of the bf16-rounded x and weight, the fp32 bias added in the
    call, cuDNN's TF32 off. Its backward rounds the cotangent too, as the JAX
    kernel's VJP and K6's dx / dw do: dx and dw are cuDNN's
    ``convolution_backward`` of the rounded operands (each saved in bf16 only
    where the other's gradient needs it, and widened again); db sums the
    cotangent as it comes."""

    @staticmethod
    def forward(ctx, x, w, b, conf):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        with _cudnn_tf32_off():
            out = torch.ops.aten.convolution(xb.to(x.dtype), wb.to(w.dtype), b, *conf)
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(xb if need_w else None, wb if need_x else None)
        ctx.conf = conf
        ctx.shapes = x.shape, w.shape
        return out

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x or need_w:
            gr = g.contiguous().to(torch.bfloat16).to(g.dtype)
            # an operand whose own gradient is not asked for gives only its
            # shape, as in torch.nn.grad.conv1d_input, but contiguous: with a
            # stride-0 one, cuDNN's dx / dw on the generator's convs ran 1.2x
            # slower against its 'highest' (chip_smoke.py phase 19, an H100)
            x = xb.to(g.dtype) if need_w else gr.new_empty(ctx.shapes[0])
            w = wb.to(g.dtype) if need_x else gr.new_empty(ctx.shapes[1])
            with _cudnn_tf32_off():
                dx, dw, _ = torch.ops.aten.convolution_backward(
                    gr, x, w, None, *ctx.conf, [need_x, need_w, False])
        if need_b:
            db = g.sum(dim=[d for d in range(g.ndim) if d != 1])
        return dx, dw, db, None


def rounded_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], *,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 transposed: bool = False) -> torch.Tensor:
    """cuDNN's conv1d / conv2d (weight (C_out, C_in / groups, *K)) or
    ConvTranspose1d (``transposed``; weight (C_in, C_out, K)) in precision
    'default' on float32 tensors (:class:`_RoundedConv`): the plain version
    of the mode (``grouped_conv1d_reference(..., precision='default')``)
    computed by cuDNN, with the mode's backward. ``stride``, ``padding``
    and ``dilation`` as ints or per-axis tuples."""
    dims = x.ndim - 2

    def per_axis(v):
        return list(v) if isinstance(v, (tuple, list)) else [v] * dims
    conf = (per_axis(stride), per_axis(padding), per_axis(dilation), transposed,
            [0] * dims, groups)
    return _RoundedConv.apply(x, weight, bias, conf)


def conv1d_route(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                 backend: str, precision: str = 'highest',
                 compute_dtype: Optional[str] = None, stride: int = 1, padding: int = 0,
                 dilation: int = 1, groups: int = 1,
                 slope: Optional[float] = None) -> torch.Tensor:
    """``leaky_relu(conv1d(x, weight) + bias)`` (slope None: no leaky_relu)
    on a conv ``backend`` in ``precision``, the body of :class:`WNConv1d`
    (and of each folded layer of :func:`~pytorch_sound_tpu_torch.models.
    vocoders.discriminators.msd_apply_folded`).

    ``compute_dtype='bf16'`` casts x and the weight to bfloat16 and returns a
    bfloat16 output (JAX ``compute_dtype``); the casts are on the autograd
    tape, so an fp32 weight gets its gradient in fp32. ``'cuda'`` runs
    :func:`~pytorch_sound_tpu_torch.ops.cuda.grouped_conv.grouped_conv1d` in
    ``precision`` (K6; bf16 tensors round the output once, after bias and
    slope). ``'cudnn'`` runs cuDNN: ``F.conv1d`` in fp32 at 'highest';
    :func:`rounded_conv` in 'default' on float32 tensors (the fp32 sum of
    the rounded operands' products, as JAX's 'default' and K6 compute it);
    on bf16 tensors cuDNN's bf16 convolution, whose bf16 output then takes
    the fp32 bias and slope and is rounded again, as the JAX package's XLA
    route does."""
    bf16 = check_compute_dtype(compute_dtype) == 'bf16'
    check_precision(precision)
    conf = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
    if bf16:
        x, weight = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    if backend == 'cuda':
        return grouped_conv1d(x, weight, bias, slope=slope, precision=precision, **conf)
    if bf16:
        out = F.conv1d(x, weight, None, **conf).float() + bias[None, :, None]
    elif precision == 'default':
        out = rounded_conv(x, weight, bias, **conf)
    else:
        out = F.conv1d(x, weight, bias, **conf)
    out = out if slope is None else F.leaky_relu(out, slope)
    return out.to(torch.bfloat16) if bf16 else out


class _WNConv(nn.Module):
    """Parameters of a conv with optional weight norm over dim 0 of ``shape``:
    ``v``, ``g`` (shape[0], 1, ...) and ``bias``, or ``weight`` and ``bias``."""

    def __init__(self, shape: Tuple[int, ...], n_bias: int, use_weight_norm: bool):
        super().__init__()
        self.use_weight_norm = use_weight_norm
        if use_weight_norm:
            self.v = nn.Parameter(torch.empty(shape))
            self.g = nn.Parameter(torch.empty((shape[0],) + (1,) * (len(shape) - 1)))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(n_bias))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX init: kernel ~ N(0, 0.01), g = its norm, bias = 0. Draws on
        the CPU from ``generator`` (the global one when None)."""
        kernel = self.v if self.use_weight_norm else self.weight
        draw = torch.randn(kernel.shape, generator=generator) * INIT_STD
        kernel.copy_(draw)
        if self.use_weight_norm:
            dims = tuple(range(1, draw.ndim))
            self.g.copy_(torch.sqrt(torch.sum(draw * draw, dim=dims, keepdim=True)))
        self.bias.zero_()

    def folded_weight(self) -> torch.Tensor:
        """The conv weight: ``weight_norm(g, v)`` or the plain weight."""
        return weight_norm(self.g, self.v) if self.use_weight_norm else self.weight


class WNConv1d(_WNConv):
    """Conv1d, weight (C_out, C_in / groups, K), weight norm per output channel.

    ``fused_slope`` applies leaky_relu to the output (JAX ``fused_slope``).
    ``backend``: ``'cudnn'`` runs ``F.conv1d``; ``'cuda'`` runs
    :func:`~pytorch_sound_tpu_torch.ops.cuda.grouped_conv.grouped_conv1d`,
    the grouped-conv kernels (K6) for the forward, dx and dw on the card and
    their plain versions on the CPU, with the slope fused into the forward
    kernel (JAX ``backend='pallas'``). ``precision`` ('highest', the port's
    default, or 'default', the JAX recipe's for the critics and, through
    ``Generator(precision=)``, the generator) and ``compute_dtype`` (None or
    'bf16', the critics only) as :func:`conv1d_route` takes them.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, padding: int = 0,
                 groups: int = 1, use_weight_norm: bool = True,
                 fused_slope: Optional[float] = None, backend: str = 'cudnn',
                 precision: str = 'highest', compute_dtype: Optional[str] = None):
        super().__init__((out_channels, in_channels // groups, kernel_size),
                         out_channels, use_weight_norm)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.padding, self.groups = padding, groups
        self.fused_slope, self.backend = fused_slope, _check_backend(backend)
        self.precision = check_precision(precision)
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def route(self) -> dict:
        """The keywords of :func:`conv1d_route` this layer runs with."""
        return dict(backend=self.backend, precision=self.precision,
                    compute_dtype=self.compute_dtype, stride=self.stride,
                    padding=self.padding, dilation=self.dilation, slope=self.fused_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_route(x, self.folded_weight(), self.bias, groups=self.groups,
                            **self.route())


class WNConvTranspose1d(_WNConv):
    """ConvTranspose1d, weight (C_in, C_out, K); ``g`` is per *input* channel
    (dim 0), as torch and the JAX package hold it. ``backend='cuda'`` runs
    :func:`~pytorch_sound_tpu_torch.ops.cuda.grouped_conv.conv_transpose1d`
    (K6: the input-gradient kernel of the mirror conv forward), ``'cudnn'``
    ``F.conv_transpose1d`` at 'highest' and :func:`rounded_conv` in
    ``precision='default'`` (JAX ``WNConvTranspose1d`` in the NTC layout)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, use_weight_norm: bool = True,
                 backend: str = 'cudnn', precision: str = 'highest'):
        super().__init__((in_channels, out_channels, kernel_size), out_channels,
                         use_weight_norm)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.backend = _check_backend(backend)
        self.precision = check_precision(precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, conf = self.folded_weight(), dict(stride=self.stride, padding=self.padding)
        if self.backend == 'cuda':
            return conv_transpose1d(x, w, self.bias, precision=self.precision, **conf)
        if self.precision == 'default':
            return rounded_conv(x, w, self.bias, transposed=True, **conf)
        return F.conv_transpose1d(x, w, self.bias, **conf)


class ResBlock1(nn.Module):
    """Two 3-conv stacks with dilations: per round
    x += conv2(lrelu(conv1(lrelu(x)))), slope 0.1. Every conv runs on
    ``backend`` in ``precision`` (:class:`WNConv1d`); on the K6 route the
    mid-block leaky_relu is fused into ``convs1`` (``fused_slope``), as the
    JAX package's NTC ResBlock1 fuses it."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), use_weight_norm: bool = True,
                 precision: str = 'highest', backend: str = 'cudnn'):
        super().__init__()
        self.dilation = tuple(dilation)
        self.fused = _check_backend(backend) == 'cuda'
        mode = dict(use_weight_norm=use_weight_norm, precision=precision, backend=backend)
        for j, d in enumerate(self.dilation):
            self.add_module('convs1_%d' % j, WNConv1d(
                channels, channels, kernel_size, dilation=d,
                padding=get_padding(kernel_size, d),
                fused_slope=0.1 if self.fused else None, **mode))
            self.add_module('convs2_%d' % j, WNConv1d(
                channels, channels, kernel_size, padding=get_padding(kernel_size, 1),
                **mode))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(len(self.dilation)):
            xt = getattr(self, 'convs1_%d' % j)(F.leaky_relu(x, 0.1))
            if not self.fused:
                xt = F.leaky_relu(xt, 0.1)
            xt = getattr(self, 'convs2_%d' % j)(xt)
            x = xt + x
        return x

    def convs(self):
        """(weight, bias, dilation) of each conv in execution order, for the
        fused stage."""
        out = []
        for j, d in enumerate(self.dilation):
            for name, dil in (('convs1_%d' % j, d), ('convs2_%d' % j, 1)):
                conv = getattr(self, name)
                out.append((conv.folded_weight(), conv.bias, dil))
        return out


class ResBlock2(nn.Module):
    """Single dilated convs: per conv x += conv(lrelu(x)), each on
    ``backend`` in ``precision``."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3), use_weight_norm: bool = True,
                 precision: str = 'highest', backend: str = 'cudnn'):
        super().__init__()
        self.dilation = tuple(dilation)
        for j, d in enumerate(self.dilation):
            self.add_module('convs_%d' % j, WNConv1d(
                channels, channels, kernel_size, dilation=d,
                padding=get_padding(kernel_size, d), use_weight_norm=use_weight_norm,
                precision=precision, backend=backend))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(len(self.dilation)):
            x = getattr(self, 'convs_%d' % j)(F.leaky_relu(x, 0.1)) + x
        return x


@register_model('hifi_gan')
class Generator(nn.Module):
    """mel (N, 80, T) -> wav (N, 1, T * prod(upsample_rates)).

    ``backend`` is the route of conv_pre, the resblock convs and conv_post,
    ``ups_backend`` that of the upsample layers (``ups_*``): ``'cudnn'`` or
    ``'cuda'``, the grouped-conv kernels (K6; JAX ``backend='pallas'``, its
    ``PSTPU_GC_DENSE_PALLAS=1`` route). ``precision`` is every conv's:
    'highest' (the port's default, fp32) or 'default', what JAX's NTC
    generator (``data_format='NTC'``, the JAX recipe's) runs at its
    ``precision='auto'``: each conv's operands rounded to bf16, fp32 sums."""

    def __init__(self, resblock: str = '1',
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 in_channels: int = 80, use_weight_norm: bool = True,
                 ups_backend: str = 'cudnn', backend: str = 'cudnn',
                 precision: str = 'highest'):
        super().__init__()
        self.resblock = resblock
        self.upsample_rates = tuple(upsample_rates)
        self.num_kernels = len(resblock_kernel_sizes)
        res_cls = ResBlock1 if resblock == '1' else ResBlock2
        ch = upsample_initial_channel
        mode = dict(use_weight_norm=use_weight_norm, precision=precision)
        self.conv_pre = WNConv1d(in_channels, ch, 7, padding=3, backend=backend, **mode)
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            self.add_module('ups_%d' % i, WNConvTranspose1d(
                ch, ch // 2, k, u, padding=(k - u) // 2, backend=ups_backend, **mode))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes,
                                             resblock_dilation_sizes)):
                self.add_module('resblocks_%d' % (i * self.num_kernels + j),
                                res_cls(ch, rk, rd, backend=backend, **mode))
        self.conv_post = WNConv1d(ch, 1, 7, padding=3, backend=backend, **mode)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """Layer by layer, differentiable (JAX ``Generator.__call__``)."""
        x = self.conv_pre(mel)
        for i in range(len(self.upsample_rates)):
            x = getattr(self, 'ups_%d' % i)(F.leaky_relu(x, 0.1))
            xs = None
            for j in range(self.num_kernels):
                out = getattr(self, 'resblocks_%d' % (i * self.num_kernels + j))(x)
                xs = out if xs is None else xs + out
            x = xs / self.num_kernels
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))

    def stage_blocks(self, i: int):
        """The (weight, bias, dilation) lists of upsample stage i's resblocks
        (ResBlock1 only), one per block."""
        return [getattr(self, 'resblocks_%d' % (i * self.num_kernels + j)).convs()
                for j in range(self.num_kernels)]

    def stage_args(self, i: int, fold_conv_pre: bool = False) -> Dict[str, Any]:
        """Keyword arguments of :func:`generator_stage` for upsample stage i
        (ResBlock1 only); the last stage carries conv_post, and stage 0 carries
        conv_pre with ``fold_conv_pre`` (its input is then the mel)."""
        up = getattr(self, 'ups_%d' % i)
        last = i == len(self.upsample_rates) - 1
        post = (self.conv_post.folded_weight(), self.conv_post.bias) if last else None
        pre = (self.conv_pre.folded_weight(), self.conv_pre.bias) \
            if fold_conv_pre and i == 0 else None
        return dict(up_weight=up.folded_weight(), up_bias=up.bias,
                    blocks=self.stage_blocks(i), upsample_rate=self.upsample_rates[i],
                    conv_post=post, conv_pre=pre)

    def folds_conv_pre(self, mel_channels: int) -> bool:
        """Whether the fused path folds conv_pre into stage 0: the JAX rule,
        ResBlock1 with a wide stage 0 (C_out = upsample_initial_channel / 2
        > 128, HiFi-GAN v1) and mel channels <= 128."""
        return (self.resblock == '1' and self.conv_pre.out_channels // 2 > 128
                and mel_channels <= 128)


def generator_apply_fused(gen: Generator, mel: torch.Tensor,
                          full_stage: bool = True, precision: str = 'highest') -> torch.Tensor:
    """Inference forward equal to ``gen(mel)`` (JAX ``generator_apply_fused``).

    With ResBlock1 and ``full_stage=True`` each upsample stage is one fused
    :func:`generator_stage` call, conv_post + tanh folded into the last:
    the CUDA kernel on a card tensor, its plain version on a CPU tensor.
    ``conv_pre`` folds into stage 0 where :meth:`Generator.folds_conv_pre`
    says so (v1), and otherwise runs through ``F.conv1d`` (as the JAX v2 path
    leaves it to XLA). ``full_stage=False`` runs conv_pre, leaky_relu and each
    upsample as layers (``F.conv1d`` / ``F.conv_transpose1d``, as JAX leaves
    them to XLA) and each stage's resblock mean through :func:`resblock_stage`
    (the kernel with its upsample off), then leaky_relu(0.01), conv_post and
    tanh. ResBlock2 (v3) has no fused kernel in either package and runs
    ``gen(mel)``. Not differentiable on the card.

    ``precision`` ('highest', 'bf16x3' or 'default'; ValueError otherwise) is
    the stage kernels' contraction mode, and as in JAX it reaches the
    full-stage route only: ``full_stage=False``, v3 and v2's unfolded
    conv_pre stay fp32.
    """
    check_mode(precision)
    if gen.resblock != '1':
        return gen(mel)
    if not full_stage:
        x = gen.conv_pre(mel)
        for i in range(len(gen.upsample_rates)):
            x = getattr(gen, 'ups_%d' % i)(F.leaky_relu(x, 0.1))
            x = resblock_stage(x, gen.stage_blocks(i))
        return torch.tanh(gen.conv_post(F.leaky_relu(x, 0.01)))
    fold = gen.folds_conv_pre(mel.shape[1])
    x = mel.contiguous() if fold else gen.conv_pre(mel)
    for i in range(len(gen.upsample_rates)):
        x = generator_stage(x, **gen.stage_args(i, fold_conv_pre=fold), precision=precision)
    return x        # conv_post + tanh are part of the last stage


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every weight-normed or plain conv of ``module`` with the JAX
    init (kernel ~ N(0, 0.01), g = its norm, bias = 0) from ``generator``, in
    module order, so a seed gives the same parameters on any device."""
    for m in module.modules():
        if isinstance(m, _WNConv):
            m.reset_parameters(generator)
    return module


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator,
                 mean: float = 0.0, std: float = 0.01) -> nn.Module:
    """Re-draw every conv kernel (a >= 2-D ``weight`` or ``v``) from
    N(mean, std), drawn on the CPU from ``generator`` (JAX ``init_weights``,
    the reference's module hook); ``g`` and biases are left as they are."""
    for name, param in module.named_parameters():
        if name.split('.')[-1] in ('weight', 'v') and param.ndim >= 2:
            param.copy_(mean + std * torch.randn(param.shape, generator=generator))
    return module


def fold_weight_norm_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold every (g, v) weight-norm pair of a numpy parameter tree into a
    plain 'weight': ``g * v / sqrt(sum(v², all dims but 0) + 1e-12)``, in
    float32 as the JAX package computes it."""
    def fold(node):
        if isinstance(node, dict):
            if 'g' in node and 'v' in node:
                v = np.asarray(node['v'], dtype=np.float32)
                g = np.asarray(node['g'], dtype=np.float32)
                axes = tuple(range(1, v.ndim))
                norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True)
                               + np.float32(1e-12))
                out = {k: fold(val) for k, val in node.items() if k not in ('g', 'v')}
                out['weight'] = g * v / norm
                return out
            return {k: fold(val) for k, val in node.items()}
        return node
    return fold(params)


def apply_weight_norm(params: Dict[str, Any]) -> Dict[str, Any]:
    """Split every plain >= 2-D 'weight' of a numpy parameter tree into a
    (g, v) pair, g the norm over all dims but 0 and v the weight itself — the
    inverse of :func:`fold_weight_norm_params` (JAX ``apply_weight_norm``).
    Existing (g, v) pairs stay as they are."""
    def split(node):
        if isinstance(node, dict):
            if 'weight' in node and 'g' not in node:
                w = np.asarray(node['weight'], dtype=np.float32)
                out = {k: split(val) for k, val in node.items() if k != 'weight'}
                if w.ndim >= 2:
                    out['g'] = np.sqrt(np.sum(w * w, axis=tuple(range(1, w.ndim)),
                                              keepdims=True))
                    out['v'] = w
                else:
                    out['weight'] = w
                return out
            return {k: split(val) for k, val in node.items()}
        return node
    return split(params)


def load_jax_params(params: Dict[str, Any], weight_norm: bool = False
                    ) -> 'OrderedDict[str, torch.Tensor]':
    """JAX parameter tree (numpy leaves) -> state dict of a Generator (or a
    critic: the trees share the naming).

    Accepts a folded tree (the bundled checkpoint) or a (g, v) tree (JAX
    ``Module.init``, the JAX trainer), with or without the top-level 'params'
    key. ``weight_norm=False`` folds (g, v) pairs into 'weight' for a
    ``use_weight_norm=False`` target; ``True`` keeps them as they are (and
    splits plain weights) for a weight-normed one.
    """
    tree = params['params'] if 'params' in params else params
    tree = apply_weight_norm(tree) if weight_norm else fold_weight_norm_params(tree)
    return tree_to_state_dict(tree)


def load_jax_trainer_params(params: Dict[str, Any], gen_weight_norm: bool = True
                            ) -> Dict[str, 'OrderedDict[str, torch.Tensor]']:
    """The JAX ``HiFiGANTrainer`` parameter tree ``{'gen', 'mpd', 'msd'}`` ->
    the three port state dicts under the same keys. The critics always carry
    weight norm; the generator's (g, v) pairs are kept for a weight-normed
    generator and folded for a ``use_weight_norm=False`` one."""
    return {'gen': load_jax_params(params['gen'], weight_norm=gen_weight_norm),
            'mpd': load_jax_params(params['mpd'], weight_norm=True),
            'msd': load_jax_params(params['msd'], weight_norm=True)}


#
# Architectures (the JAX package's registry, the HiFi-GAN paper's configs):
# v1 ~14M params; v2 ~0.9M params; v3 uses ResBlock2 at 256x upsampling.
#
@register_model_architecture('hifi_gan', 'hifi_gan_v1')
def hifi_gan_v1():
    return {
        'resblock': '1',
        'upsample_rates': (8, 8, 2, 2),
        'upsample_kernel_sizes': (16, 16, 4, 4),
        'upsample_initial_channel': 512,
        'resblock_kernel_sizes': (3, 7, 11),
        'resblock_dilation_sizes': ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        'use_weight_norm': True,
        'ups_backend': 'cudnn',
        'backend': 'cudnn',
        'precision': 'highest',
    }


@register_model_architecture('hifi_gan', 'hifi_gan_v2')
def hifi_gan_v2():
    return {
        'resblock': '1',
        'upsample_rates': (8, 8, 2, 2),
        'upsample_kernel_sizes': (16, 16, 4, 4),
        'upsample_initial_channel': 128,
        'resblock_kernel_sizes': (3, 7, 11),
        'resblock_dilation_sizes': ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        'use_weight_norm': True,
        'ups_backend': 'cudnn',
        'backend': 'cudnn',
        'precision': 'highest',
    }


@register_model_architecture('hifi_gan', 'hifi_gan_v3')
def hifi_gan_v3():
    return {
        'resblock': '2',
        'upsample_rates': (8, 8, 4),
        'upsample_kernel_sizes': (16, 16, 8),
        'upsample_initial_channel': 256,
        'resblock_kernel_sizes': (3, 5, 7),
        'resblock_dilation_sizes': ((1, 2), (2, 6), (3, 12)),
        'use_weight_norm': True,
        'ups_backend': 'cudnn',
        'backend': 'cudnn',
        'precision': 'highest',
    }
