"""Fused HiFi-GAN upsample stage and resblock stage: wrappers of the CUDA
kernel ``csrc/gen_stage.cu``.

Counterparts of ``pytorch_sound_tpu/ops/pallas/gen_stage.py``
(``fused_generator_stage``, K1) and ``pytorch_sound_tpu/ops/pallas/resblock.py``
(``fused_resblock_stage``, K3):

- :func:`generator_stage`, one stage of the generator, whole:
  [conv_pre on stage 0 ->] leaky_relu(0.1) -> ConvTranspose1d(2C -> C,
  stride u) -> mean of the ResBlock1 stacks [-> leaky_relu(0.01) ->
  conv_post -> tanh on the last stage];
- :func:`resblock_stage`, the same kernel with the upsample off: the mean of
  the ResBlock1 stacks of (N, C, T), every conv masked to [0, T).

Each dispatches on the tensor's device: on the CPU it runs its plain version
(:func:`generator_stage_reference`, :func:`resblock_stage_reference`), on a
CUDA tensor it launches the kernel or raises. The kernel takes C <= 64 (a
multiple of 8; one thread block per time tile), C = 128 and C = 256 (HiFi-GAN
v1's wide stages; a thread-block cluster of C / 32 blocks per time tile), and
resblock kernel sizes 3, 7 and 11; C = 512 is refused, as the JAX
``stage_eligible`` refuses it, and conv_post folds only into a stage of C <=
64 (HiFi-GAN's last stages). The kernel's entry points pick their time tile
from the card's shared memory per block.

A stage's resblocks are given as ``blocks``: one list per ResBlock1 of
``(weight (C, C, k), bias (C,), dilation)`` triples in execution order
(convs1_0, convs2_0, convs1_1, convs2_1, ...). The kernel runs the resblock
convs as 3xTF32 products on the tensor cores and reads each weight as TF32
fragments (:func:`tf32_fragments` is their plain version), which the entry
point splits on every call, in a launch of its own before the stage's: a
write to the weights by any route, ``.data`` included, reaches the next
launch. The transposed conv runs on the tensor cores the same way.

``precision`` is the JAX kernels' contraction mode, taken by every product
of the stage (conv_pre, the transposed conv, the resblock convs,
conv_post): 'highest' (fp32 accuracy, the 3xTF32 products above), 'bf16x3'
(the three bf16 products of hi / lo splits, hi = bf16(x), lo = bf16(x -
hi), lo·lo dropped) or 'default' (one product of bf16-rounded operands,
what a TPU's Precision.DEFAULT computes), both rounding to nearest even and
both on the bf16 tensor cores, the weights split into bf16 fragments
(:func:`bf16_fragments`). The resblock stage takes 'highest' and 'default'
only, as ``fused_resblock_stage`` does. leaky_relu, biases, residual adds,
the block mean and tanh stay fp32 in every mode. Each wrapper counts its
launches per mode in ``launches_by_mode`` (:func:`launch_count` sums them).
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch.ops.cuda import _build

SOURCE = 'pytorch_sound_tpu_torch/csrc/gen_stage.cu'
HALO = 64          # >= one-sided receptive field: 60 for k<=11, d<=5, + 3 for conv_post
MAX_CHANNELS = 64      # the single-block layout
WIDE_CHANNELS = (128, 256)   # the cluster layout (C / 32 blocks per tile)
MAX_BLOCKS = 8         # the kernel's plan capacity (HiFi-GAN v1 / v2 use 3 blocks
MAX_CONVS = 32         # of 6 convs)
KERNEL_SIZES = (3, 7, 11)   # resblock kernel sizes the kernel is compiled for
MODES = {'highest': 0, 'bf16x3': 1, 'default': 2}   # the entry points' `mode`
RESBLOCK_MODES = ('highest', 'default')             # fused_resblock_stage's modes

Conv = Tuple[torch.Tensor, torch.Tensor, int]
Pair = Tuple[torch.Tensor, torch.Tensor]


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), back in fp32."""
    return x.to(torch.bfloat16).float()


def _mode_conv(conv, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               precision: str, **kw) -> torch.Tensor:
    """``conv(x, w, b, **kw)`` with its products taken as JAX's dot takes
    them in ``precision``: fp32 ('highest'); the three fp32 convs of bf16
    splits lo_x hi_w + hi_x lo_w + hi_x hi_w ('bf16x3'); the fp32 conv of
    bf16-rounded operands ('default'). A bf16 product is exact in fp32, so
    only the sums' order differs from the kernels'."""
    if precision == 'highest':
        return conv(x, w, b, **kw)
    xh, wh = _bf16(x), _bf16(w)
    if precision == 'default':
        return conv(xh, wh, b, **kw)
    return conv(_bf16(x - xh), wh, **kw) + conv(xh, _bf16(w - wh), **kw) + conv(xh, wh, b, **kw)


def resblock1(x: torch.Tensor, convs: Sequence[Conv], precision: str = 'highest'
              ) -> torch.Tensor:
    """ResBlock1: per round, x += conv2(lrelu(conv1(lrelu(x)))), slope 0.1."""
    for (w1, b1, d1), (w2, b2, d2) in zip(convs[0::2], convs[1::2]):
        xt = _mode_conv(F.conv1d, F.leaky_relu(x, 0.1), w1, b1, precision, dilation=d1,
                        padding=get_padding(w1.shape[-1], d1))
        xt = _mode_conv(F.conv1d, F.leaky_relu(xt, 0.1), w2, b2, precision, dilation=d2,
                        padding=get_padding(w2.shape[-1], d2))
        x = xt + x
    return x


def resblock_stage_reference(x: torch.Tensor, blocks: Sequence[Sequence[Conv]],
                             precision: str = 'highest') -> torch.Tensor:
    """Plain PyTorch resblock stage: the mean of the ResBlock1 stacks of x
    (N, C, T) -> (N, C, T); each conv's zero padding is the [0, T) mask."""
    xs = None
    for convs in blocks:
        out = resblock1(x, convs, precision)
        xs = out if xs is None else xs + out
    return xs / len(blocks)


def generator_stage_reference(x: torch.Tensor, up_weight: torch.Tensor,
                              up_bias: torch.Tensor, blocks: Sequence[Sequence[Conv]],
                              upsample_rate: int, conv_post: Optional[Pair] = None,
                              conv_pre: Optional[Pair] = None,
                              precision: str = 'highest') -> torch.Tensor:
    """Plain PyTorch stage: x (N, 2C, T) -> (N, C, uT), or (N, 1, uT) with
    ``conv_post = (weight (1, C, k), bias (1,))`` on the last stage. With
    ``conv_pre = (weight (2C, C_mel, k), bias (2C,))``, x is the mel
    (N, C_mel, T) and conv_pre runs first. Every product in ``precision``."""
    if conv_pre is not None:
        w, b = conv_pre
        x = _mode_conv(F.conv1d, x, w, b, precision, padding=(w.shape[-1] - 1) // 2)
    k_up = up_weight.shape[-1]
    x = F.leaky_relu(x, 0.1)
    x = _mode_conv(F.conv_transpose1d, x, up_weight, up_bias, precision,
                   stride=upsample_rate, padding=(k_up - upsample_rate) // 2)
    x = resblock_stage_reference(x, blocks, precision)
    if conv_post is not None:
        w, b = conv_post
        x = torch.tanh(_mode_conv(F.conv1d, F.leaky_relu(x, 0.01), w, b, precision,
                                  padding=(w.shape[-1] - 1) // 2))
    return x


def tf32_fragments(w: torch.Tensor) -> torch.Tensor:
    """A conv weight (C_out, C_in, k) split into TF32 hi / lo in the order the
    kernel reads its mma B fragments: (k, C_in / 8, C_out / 8, 8, 4, 2, 2) =
    (tap j, k-step s, n-tile n, g, t, hi / lo, h), entry w[8n + g][8s + 4h +
    t][j]; lane 4g + t of a warp reads its four floats with one 16-byte load.
    hi is w rounded to TF32 (the tensor cores read the top 19 bits) and lo =
    w - hi, as ``split_tf32`` in ``csrc/tf32_mma.cuh`` splits an operand."""
    c_out, c_in, k = w.shape
    w = w.contiguous()
    hi = ((w.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = w - hi

    def order(x):
        return x.reshape(c_out // 8, 8, c_in // 8, 2, 4, k).permute(5, 2, 0, 1, 4, 3)
    return torch.stack([order(hi), order(lo)], dim=-2).contiguous()


def bf16_fragments(w: torch.Tensor, precision: str = 'bf16x3') -> torch.Tensor:
    """A conv weight (C_out, C_in, k) as the kernel's bf16 modes read their
    mma m16n8k16 B fragments: bfloat16 (k, ceil(C_in / 16), C_out / 8, 8, 4,
    P, 2, 2) = (tap j, k-step s, n-tile n, g, t, hi / lo, register r, half
    h), entry w[8n + g][16s + 8r + 4h + t][j], zero where that input channel
    is past C_in; lane 4g + t of a warp reads its 2P registers with one load.
    hi = bf16(w) and lo = bf16(w - hi), rounded to nearest even (P = 2,
    'bf16x3'), or hi alone (P = 1, 'default'), as ``bf16_split_kernel`` in
    ``csrc/gen_stage.cu`` writes them."""
    c_out, c_in, k = w.shape
    c16 = -(-c_in // 16) * 16
    w = F.pad(w.contiguous(), (0, 0, 0, c16 - c_in))
    hi = w.to(torch.bfloat16)
    parts = [hi] if precision == 'default' else [hi, (w - hi.float()).to(torch.bfloat16)]

    def order(x):
        return x.reshape(c_out // 8, 8, c16 // 16, 2, 2, 4, k).permute(6, 2, 0, 1, 5, 3, 4)
    return torch.stack([order(p) for p in parts], dim=-3).contiguous()


def check_mode(precision: str, modes=tuple(MODES)) -> int:
    """The entry points' ``mode`` of ``precision``; ValueError unless it is
    one of ``modes``."""
    if precision not in modes:
        raise ValueError('precision must be one of %s, got %r' % (modes, precision))
    return MODES[precision]


def _check_width(c: int):
    if not (c <= MAX_CHANNELS and c % 8 == 0 or c in WIDE_CHANNELS):
        raise ValueError('stage kernel takes C <= %d (a multiple of 8) or C in %s; got C = %d'
                         % (MAX_CHANNELS, WIDE_CHANNELS, c))


def _check_blocks(c: int, blocks: Sequence[Sequence[Conv]], post_half: int = 0):
    """Raise ValueError on resblocks the kernel does not take; return their
    tensors."""
    if not 1 <= len(blocks) <= MAX_BLOCKS or sum(map(len, blocks)) > MAX_CONVS:
        raise ValueError('stage kernel takes 1..%d blocks and <= %d convs'
                         % (MAX_BLOCKS, MAX_CONVS))
    tensors = []
    for convs in blocks:
        if not convs or len(convs) % 2:
            raise ValueError('a ResBlock1 runs whole rounds of two convs')
        reach = 0
        for w, b, d in convs:
            if w.shape[:2] != (c, c) or w.shape[2] not in KERNEL_SIZES \
                    or tuple(b.shape) != (c,) or d < 1:
                raise ValueError('resblock conv must be (C, C, k) with k in %s: %s, d=%d'
                                 % (KERNEL_SIZES, tuple(w.shape), d))
            reach += (w.shape[2] - 1) // 2 * d
            tensors += [w, b]
        if reach + post_half > HALO:
            raise ValueError('receptive field %d exceeds the %d-sample halo'
                             % (reach + post_half, HALO))
    return tensors


def _check_tensors(x: torch.Tensor, tensors):
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError('stage kernel takes contiguous float32 tensors on one device')


def check_stage(x: torch.Tensor, up_weight: torch.Tensor, up_bias: torch.Tensor,
                blocks: Sequence[Sequence[Conv]], upsample_rate: int,
                conv_post: Optional[Pair] = None, conv_pre: Optional[Pair] = None,
                precision: str = 'highest'):
    """Raise ValueError on anything the kernel does not take."""
    check_mode(precision)
    if x.ndim != 3:
        raise ValueError('stage input must be (N, 2C, T), got %s' % (tuple(x.shape),))
    n, c_in, t_in = x.shape
    c_up, c, k_up = up_weight.shape
    u = upsample_rate
    tensors = [x, up_weight, up_bias]
    if conv_pre is not None:
        w, b = conv_pre
        if w.ndim != 3 or w.shape[1] != c_in or w.shape[2] % 2 == 0 \
                or tuple(b.shape) != (w.shape[0],):
            raise ValueError('conv_pre must be (2C, C_mel, odd k) over the mel input: '
                             'weight %s, x %s' % (tuple(w.shape), tuple(x.shape)))
        c_in = w.shape[0]
        tensors += [w, b]
    if c_up != c_in or c_in != 2 * c or tuple(up_bias.shape) != (c,):
        raise ValueError('stage takes 2C -> C channels: x %s, up weight %s'
                         % (tuple(x.shape), tuple(up_weight.shape)))
    _check_width(c)
    if n < 1 or t_in < 1:
        raise ValueError('empty stage input %s' % (tuple(x.shape),))
    if (k_up - u) % 2 or not 0 <= (k_up - u) // 2 < u or HALO % u:
        raise ValueError('unsupported upsample geometry u=%d k=%d' % (u, k_up))
    post_half = 0
    if conv_post is not None:
        w, b = conv_post
        if w.shape[:2] != (1, c) or w.shape[2] % 2 == 0 or tuple(b.shape) != (1,):
            raise ValueError('conv_post must be (1, C, odd k), got %s' % (tuple(w.shape),))
        if c > MAX_CHANNELS:
            raise ValueError('conv_post folds into a stage of C <= %d only' % MAX_CHANNELS)
        post_half = (w.shape[2] - 1) // 2
        tensors += [w, b]
    tensors += _check_blocks(c, blocks, post_half)
    _check_tensors(x, tensors)


def check_resblock_stage(x: torch.Tensor, blocks: Sequence[Sequence[Conv]],
                         precision: str = 'highest'):
    """Raise ValueError on anything the kernel's resblock mode does not take."""
    check_mode(precision, RESBLOCK_MODES)
    if x.ndim != 3 or x.shape[0] < 1 or x.shape[2] < 1:
        raise ValueError('resblock stage input must be (N, C, T), got %s' % (tuple(x.shape),))
    c = x.shape[1]
    _check_width(c)
    _check_tensors(x, [x] + _check_blocks(c, blocks))


def _device(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise on any other."""
    if x.device.type not in ('cpu', 'cuda'):
        raise RuntimeError('%s runs on cpu or cuda, not %s' % (name, x.device))
    return x.device.type == 'cuda'


def _plan_args(blocks: Sequence[Sequence[Conv]]):
    """The C plan arguments of the resblock convs."""
    convs = [conv for block in blocks for conv in block]
    return (len(blocks), _build.int_array([len(b) // 2 for b in blocks]),
            _build.int_array([w.shape[2] for w, _, _ in convs]),
            _build.int_array([d for _, _, d in convs]),
            _build.ptr_array([w for w, _, _ in convs]),
            _build.ptr_array([b for _, b, _ in convs]))


def generator_stage(x: torch.Tensor, up_weight: torch.Tensor, up_bias: torch.Tensor,
                    blocks: Sequence[Sequence[Conv]], upsample_rate: int,
                    conv_post: Optional[Pair] = None, conv_pre: Optional[Pair] = None,
                    precision: str = 'highest') -> torch.Tensor:
    """One generator stage in ``precision``: the plain version on the CPU,
    the kernel on CUDA. ``launches_by_mode`` counts the launches per
    precision, ``wide_launches`` those of the cluster layout (C > 64)."""
    mode = check_mode(precision)
    if not _device(x, 'generator_stage'):
        return generator_stage_reference(x, up_weight, up_bias, blocks,
                                         upsample_rate, conv_post, conv_pre, precision)
    check_stage(x, up_weight, up_bias, blocks, upsample_rate, conv_post, conv_pre, precision)
    n, _, t_in = x.shape
    c, k_up = up_weight.shape[1], up_weight.shape[2]
    post_w, post_b = conv_post if conv_post is not None else (None, None)
    pre_w, pre_b = conv_pre if conv_pre is not None else (None, None)
    out = torch.empty((n, 1 if conv_post is not None else c, t_in * upsample_rate),
                      dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _build.library().gen_stage_forward(
            x.data_ptr(), out.data_ptr(), n, c, t_in, upsample_rate, k_up,
            up_weight.data_ptr(), up_bias.data_ptr(), *_plan_args(blocks),
            post_w.data_ptr() if post_w is not None else None,
            post_b.data_ptr() if post_b is not None else None,
            post_w.shape[2] if post_w is not None else 0,
            pre_w.data_ptr() if pre_w is not None else None,
            pre_b.data_ptr() if pre_b is not None else None,
            pre_w.shape[1] if pre_w is not None else 0,
            pre_w.shape[2] if pre_w is not None else 0,
            mode, torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'gen_stage_forward')
    generator_stage.launches_by_mode[precision] += 1
    if c > MAX_CHANNELS:
        generator_stage.wide_launches += 1
    return out


generator_stage.launches_by_mode = dict.fromkeys(MODES, 0)
generator_stage.wide_launches = 0


def resblock_stage(x: torch.Tensor, blocks: Sequence[Sequence[Conv]],
                   precision: str = 'highest') -> torch.Tensor:
    """The mean of the ResBlock1 stacks of x (N, C, T) -> (N, C, T) in
    ``precision`` ('highest' or 'default'): the plain version on the CPU, the
    kernel with its upsample off on CUDA."""
    mode = check_mode(precision, RESBLOCK_MODES)
    if not _device(x, 'resblock_stage'):
        return resblock_stage_reference(x, blocks, precision)
    check_resblock_stage(x, blocks, precision)
    n, c, t = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = _build.library().resblock_stage_forward(
            x.data_ptr(), out.data_ptr(), n, c, t, *_plan_args(blocks),
            mode, torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'resblock_stage_forward')
    resblock_stage.launches_by_mode[precision] += 1
    return out


resblock_stage.launches_by_mode = dict.fromkeys(RESBLOCK_MODES, 0)


def launch_count(wrapper) -> int:
    """The launches of :func:`generator_stage` or :func:`resblock_stage`
    over all modes."""
    return sum(wrapper.launches_by_mode.values())


def reset_launches():
    """Set both wrappers' counts, per mode and wide, to 0."""
    for wrapper in (generator_stage, resblock_stage):
        wrapper.launches_by_mode = dict.fromkeys(wrapper.launches_by_mode, 0)
    generator_stage.wide_launches = 0
