"""Grouped / strided conv1d and ConvTranspose1d: wrappers of the CUDA kernels
``csrc/grouped_conv.cu`` (K6).

Counterpart of ``pytorch_sound_tpu/ops/pallas/grouped_conv.py`` on its kernel
route (``grouped_conv1d_ntc`` / ``conv_transpose1d_ntc`` with
``backend='pallas'``), in the port's NCT layout. Three entry points, each with
a launch counter:

- :func:`conv1d_forward`: ``leaky_relu(conv1d(x, w) + b)``, bias and slope
  optional (K6a, the forward);
- :func:`conv1d_input_grad`: the input gradient of that conv from its
  cotangent, with an optional bias and slope in the epilogue, which makes it
  also the forward of ConvTranspose1d (K6a, dx and convT). Both run on the
  tensor cores (3xTF32, ``conv_tap_kernel``) from ``TC_MIN_ROWS`` GEMM rows
  per group, on the CUDA cores below (:func:`fwd_kernel`,
  :func:`dx_kernel`);
- :func:`conv1d_weight_grad`: the weight gradient, deterministic (K6b): on
  the tensor cores (3xTF32) from ``DW_TC_MIN_ROWS`` output channels per
  group, on the CUDA cores below (:func:`dw_kernel`).

Each dispatches on the tensor's device: on the CPU it runs its plain version
(``F.conv1d``, ``torch.nn.grad.conv1d_input``, ``torch.nn.grad.conv1d_weight``),
on a CUDA tensor it launches its kernel or raises. Every geometry runs on the
kernel: any ``groups`` dividing both channel counts, one input or one output
channel, any stride, dilation and length (the JAX package's ``eligible()``
answers TPU lane limits and has no counterpart here).

:func:`grouped_conv1d` and :func:`conv_transpose1d` are autograd functions
over the three with the JAX package's VJP (``_pgc_bwd``, ``_pct_bwd``): the
slope mask from the saved output (``out > 0``), ``db`` as a sum, and for
ConvTranspose1d the roles of input and cotangent swapped.

Each takes ``precision``, the TPU kernel's two modes: ``'highest'`` (the
port's default: fp32-accurate products, 3xTF32 on the tensor cores) or
``'default'`` (the JAX package's default: each operand rounded to bf16,
round to nearest even, the products summed in fp32, as
``_kernel`` / ``_dw_kernel`` do in ``precision='default'``; bf16
``mma.sync`` m16n8k16 on the tensor cores, fp32 FMAs of the rounded operands
on the CUDA cores). The tensors are float32, or bfloat16 together (x, w and
gy; the bias stays float32): bf16 operands run the bf16 products in either
precision (they are exact), the output is rounded to bf16 once from the fp32
sum after bias and slope, and dw comes back in the weight's dtype. The plain
version of a mode is the fp32 conv of the rounded operands
(``F.conv1d(x.bfloat16().float(), w.bfloat16().float(), ...)``), cast to the
tensors' dtype. ``launches_by_mode`` counts each entry point's launches by
route: 'highest', 'default' (float32 tensors) and 'bf16' (bfloat16 tensors).
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch.ops.cuda import _build

SOURCE = 'pytorch_sound_tpu_torch/csrc/grouped_conv.cu'
DW_BLOCKS_PER_SM = 8        # the weight gradient's split aims at this many blocks
DW_MIN_CHUNK = 256          # (item, time) positions per split at least
DW_TC_MIN_ROWS = 16         # output channels per group from which dw runs on the tensor cores
TC_MIN_ROWS = 16            # GEMM rows per group from which fwd and dx run on the tensor cores
TAP_BK = 32                 # the tap kernel's reduction indices (channel, tap) per stage
TAP_STAGES = 3              # the tap kernel's cp.async ring
TAP_MAX_SMEM = 232448       # bytes of shared memory one block may take on the H100
PRECISIONS = ('highest', 'default')     # csrc/grouped_conv.cu's Prec: 0, 1
ROUTES = ('highest', 'default', 'bf16')  # launches_by_mode's keys
DTYPES = (torch.float32, torch.bfloat16)


def conv_out_len(t_in: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1) -> int:
    return (t_in + 2 * padding - dilation * (kernel_size - 1) - 1) // stride + 1


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError('precision must be one of %s, got %r' % (PRECISIONS, precision))
    return precision


def _operands(precision: str, *tensors: torch.Tensor):
    """The tensors as the plain version of ``precision`` multiplies them:
    bfloat16 widened to float32, others in their dtype, each rounded to bf16
    first in 'default'."""
    wide = [t.float() if t.dtype == torch.bfloat16 else t for t in tensors]
    if check_precision(precision) == 'default':
        return [t.to(torch.bfloat16).to(t.dtype) for t in wide]
    return wide


def grouped_conv1d_reference(x: torch.Tensor, w: torch.Tensor,
                             b: Optional[torch.Tensor] = None, *, stride: int = 1,
                             padding: int = 0, groups: int = 1, dilation: int = 1,
                             slope: Optional[float] = None,
                             precision: str = 'highest') -> torch.Tensor:
    """Plain forward: ``F.conv1d`` + bias, then ``F.leaky_relu`` if ``slope``,
    on the operands of ``precision``, in x's dtype."""
    xo, wo = _operands(precision, x, w)
    out = F.conv1d(xo, wo, None if b is None else b.to(xo.dtype), stride=stride,
                   padding=padding, dilation=dilation, groups=groups)
    return (out if slope is None else F.leaky_relu(out, slope)).to(x.dtype)


def conv1d_input_grad_reference(gy: torch.Tensor, w: torch.Tensor, t_in: int, *,
                                stride: int = 1, padding: int = 0, groups: int = 1,
                                dilation: int = 1, precision: str = 'highest'
                                ) -> torch.Tensor:
    """Plain input gradient (N, C_in, t_in) of the conv from its cotangent,
    on the operands of ``precision``, in gy's dtype."""
    size = (gy.shape[0], w.shape[1] * groups, t_in)
    go, wo = _operands(precision, gy, w)
    return torch.nn.grad.conv1d_input(size, wo, go, stride, padding, dilation,
                                      groups).to(gy.dtype)


def conv1d_weight_grad_reference(x: torch.Tensor, gy: torch.Tensor,
                                 w_shape: Sequence[int], *, stride: int = 1,
                                 padding: int = 0, groups: int = 1,
                                 dilation: int = 1, precision: str = 'highest'
                                 ) -> torch.Tensor:
    """Plain weight gradient (C_out, C_in / groups, K) of the conv, on the
    operands of ``precision``, in x's dtype."""
    xo, go = _operands(precision, x, gy)
    return torch.nn.grad.conv1d_weight(xo, tuple(w_shape), go, stride, padding,
                                       dilation, groups).to(x.dtype)


def conv_transpose1d_reference(x: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor] = None, *, stride: int = 1,
                               padding: int = 0, slope: Optional[float] = None,
                               precision: str = 'highest') -> torch.Tensor:
    """Plain ConvTranspose1d, w (C_in, C_out, K), then leaky_relu if
    ``slope``, on the operands of ``precision``, in x's dtype."""
    xo, wo = _operands(precision, x, w)
    out = F.conv_transpose1d(xo, wo, None if b is None else b.to(xo.dtype), stride=stride,
                             padding=padding)
    return (out if slope is None else F.leaky_relu(out, slope)).to(x.dtype)


def _epilogue(out: torch.Tensor, b: Optional[torch.Tensor],
              slope: Optional[float], dtype: torch.dtype) -> torch.Tensor:
    if b is not None:
        out = out + b.to(out.dtype)[None, :, None]
    return (out if slope is None else F.leaky_relu(out, slope)).to(dtype)


def _check(name: str, operands, bias: Optional[torch.Tensor] = None) -> bool:
    """The kernels take contiguous tensors on one CUDA device: the operands
    all float32 or all bfloat16, the bias float32. Returns whether they are
    bfloat16."""
    dev = operands[0].device
    if dev.type != 'cuda':
        raise RuntimeError('%s runs on cpu or cuda, not %s' % (name, dev))
    dtype = operands[0].dtype
    if dtype not in DTYPES:
        raise ValueError('%s kernel takes float32 or bfloat16 tensors, got %s' % (name, dtype))
    for t, want in [(t, dtype) for t in operands] + [(bias, torch.float32)]:
        if t is None:
            continue
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError('%s kernel takes contiguous %s tensors on %s, got %s %s on %s'
                             % (name, want, dev, t.dtype, tuple(t.shape), t.device))
    return dtype == torch.bfloat16


def _count(wrapper, precision: str, bf16: bool):
    wrapper.launches += 1
    wrapper.launches_by_mode['bf16' if bf16 else precision] += 1


def reset_launches():
    """Set the three entry points' counts, total and per route, to 0."""
    for wrapper in (conv1d_forward, conv1d_input_grad, conv1d_weight_grad):
        wrapper.launches = 0
        wrapper.launches_by_mode = dict.fromkeys(ROUTES, 0)


def _geometry(name: str, n: int, cin: int, cout: int, w: torch.Tensor, groups: int):
    cout_w, cg, _ = w.shape
    if groups < 1 or cin != cg * groups or cout != cout_w or cout % groups:
        raise ValueError('%s: weight %s does not fit %d -> %d channels in %d groups'
                         % (name, tuple(w.shape), cin, cout, groups))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def conv1d_forward(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                   *, stride: int = 1, padding: int = 0, groups: int = 1,
                   dilation: int = 1, slope: Optional[float] = None,
                   precision: str = 'highest') -> torch.Tensor:
    """x (N, C_in, T) -> leaky_relu(conv1d(x, w) + b) (N, C_out, T_out) in
    x's dtype; w (C_out, C_in / groups, K). The kernel on a CUDA tensor, the
    plain version of ``precision`` on a CPU tensor."""
    check_precision(precision)
    if x.device.type == 'cpu':
        return grouped_conv1d_reference(x, w, b, stride=stride, padding=padding,
                                        groups=groups, dilation=dilation, slope=slope,
                                        precision=precision)
    bf16 = _check('conv1d_forward', (x, w), b)
    n, cin, t_in = x.shape
    cout, _, k = w.shape
    _geometry('conv1d_forward', n, cin, cout, w, groups)
    t_out = conv_out_len(t_in, k, stride, padding, dilation)
    if t_out < 1:
        raise ValueError('conv1d_forward: input of %d samples is shorter than the kernel'
                         % t_in)
    y = torch.empty((n, cout, t_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = _build.library().grouped_conv_forward(
            x.data_ptr(), w.data_ptr(), _ptr(b), y.data_ptr(), n, cin, t_in, cout,
            t_out, k, stride, padding, dilation, groups, slope is not None,
            slope or 0.0, PRECISIONS.index(precision), bf16,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'grouped_conv_forward')
    _count(conv1d_forward, precision, bf16)
    return y


def conv1d_input_grad(gy: torch.Tensor, w: torch.Tensor, t_in: int,
                      b: Optional[torch.Tensor] = None, *, stride: int = 1,
                      padding: int = 0, groups: int = 1, dilation: int = 1,
                      slope: Optional[float] = None, precision: str = 'highest'
                      ) -> torch.Tensor:
    """Input gradient (N, C_in, t_in) of the conv from gy (N, C_out, T_out),
    then ``+ b`` (C_in,) and leaky_relu when given, in gy's dtype. With
    groups 1 and dilation 1 this is ConvTranspose1d of gy with weight w
    (C_out, C_in, K)."""
    check_precision(precision)
    if gy.device.type == 'cpu':
        # bf16 widened first: the bias and slope apply before the one rounding
        go, wo = (t.float() if t.dtype == torch.bfloat16 else t for t in (gy, w))
        dx = conv1d_input_grad_reference(go, wo, t_in, stride=stride, padding=padding,
                                         groups=groups, dilation=dilation,
                                         precision=precision)
        return _epilogue(dx, b, slope, gy.dtype)
    bf16 = _check('conv1d_input_grad', (gy, w), b)
    n, cout, t_out = gy.shape
    _, cg, k = w.shape
    cin = cg * groups
    _geometry('conv1d_input_grad', n, cin, cout, w, groups)
    if t_in < 1 or conv_out_len(t_in, k, stride, padding, dilation) != t_out:
        raise ValueError('conv1d_input_grad: %d input samples do not give %d outputs'
                         % (t_in, t_out))
    dx = torch.empty((n, cin, t_in), dtype=gy.dtype, device=gy.device)
    with torch.cuda.device(gy.device):
        code = _build.library().grouped_conv_input_grad(
            gy.data_ptr(), w.data_ptr(), _ptr(b), dx.data_ptr(), n, cin, t_in, cout,
            t_out, k, stride, padding, dilation, groups, slope is not None,
            slope or 0.0, PRECISIONS.index(precision), bf16,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'grouped_conv_input_grad')
    _count(conv1d_input_grad, precision, bf16)
    return dx


def dw_kernel(rows: int) -> str:
    """The CUDA kernel that computes the weight gradient for ``rows`` output
    channels per group: ``conv_dw_kernel`` (tensor cores) from
    ``DW_TC_MIN_ROWS`` on, ``conv_gemm_kernel`` (CUDA cores) below, where an
    m16 tile would waste most of its rows (conv_post has one)."""
    return 'conv_dw_kernel' if rows >= DW_TC_MIN_ROWS else 'conv_gemm_kernel'


def fwd_kernel(rows: int, depth: int) -> str:
    """The CUDA kernel that computes the forward for ``rows`` output channels
    per group and a reduction of ``depth`` = (C_in / groups) * K:
    ``conv_tap_kernel`` (tensor cores) from ``TC_MIN_ROWS`` rows and one
    stage (``TAP_BK``) of reduction on, ``conv_gemm_kernel`` (CUDA cores)
    below: conv_post has one row, the critics' first layers one input
    channel (a reduction of 5 or 15, where the CUDA-core kernel measured
    up to twice as fast; conv_post's dx has a reduction of 3). A geometry
    whose window overflows a block (:func:`tap_plan`; none of the critics'
    or upsamples') also takes ``conv_gemm_kernel``."""
    return ('conv_tap_kernel' if rows >= TC_MIN_ROWS and depth >= TAP_BK
            else 'conv_gemm_kernel')


def dx_kernel(rows: int, depth: int) -> str:
    """The same for dx and ConvTranspose1d, whose GEMM rows are the input
    channels per group (a critic's first layer has one, v2's last upsample
    eight) and whose reduction is (C_out / groups) times the taps of its
    longest stride phase (:func:`dx_depth`)."""
    return fwd_kernel(rows, depth)


def dx_depth(cout: int, k: int, stride: int = 1, padding: int = 0, dilation: int = 1,
             groups: int = 1) -> int:
    """dx's reduction length: output channels per group times the taps of
    the longest stride phase."""
    return cout // groups * max(dx_phase(rho, k, stride, padding, dilation, 0)[2]
                                for rho in range(stride))       # taps: any length


def tap_tile(rows: int):
    """(rows, columns) of ``conv_tap_kernel``'s block tile for ``rows`` GEMM
    rows per group (``dispatch_tap`` in the CUDA source)."""
    for least, tile in ((128, (128, 64)), (64, (64, 64)), (32, (32, 128))):
        if rows >= least:
            return tile
    return 16, 256


def tap_pitch(lp: int, stride: int) -> int:
    """Floats of one phase row of the tap kernel's window: at least ``lp``,
    16 / 11 / 8 mod 32 at stride 2 / 3 / >= 4 so that the 4 taps of a B
    fragment land in different banks."""
    if stride == 1:
        return lp
    return lp + (({2: 16, 3: 11}.get(stride, 8) - lp) % 32)


def dx_phase(rho: int, k: int, stride: int, padding: int, dilation: int, t_in: int):
    """(m0, ms, n_taps, base, dstep, j_count) of dx's stride phase ``rho``
    (``dx_phase`` in the CUDA source): outputs u = rho + stride j, j <
    j_count, read taps m = m0 + ms i, i < n_taps, at cotangent time
    j + base - i dstep."""
    gc_ = math.gcd(stride, dilation)
    ms, dstep = stride // gc_, dilation // gc_
    m0 = next((m for m in range(min(ms, k)) if (rho + padding - dilation * m) % stride == 0),
              None)
    n_taps = 0 if m0 is None else (k - 1 - m0) // ms + 1
    base = 0 if m0 is None else (rho + padding - dilation * m0) // stride
    j_count = -(-(t_in - rho) // stride) if rho < t_in else 0
    return (-1 if m0 is None else m0), ms, n_taps, base, dstep, j_count


def tap_plan(mode: str, n: int, cin: int, t_in: int, cout: int, t_out: int, k: int,
             stride: int = 1, padding: int = 0, dilation: int = 1, groups: int = 1) -> dict:
    """``conv_tap_kernel``'s plan for ``mode`` 'fwd' or 'dx' (``tap_plan`` in
    the CUDA source): the tile, the window's extra entries per item segment
    (``qx``), phase-row and channel-slot pitches, channel slots per stage,
    floats per ring stage and the shared memory in bytes."""
    rows = cout // groups if mode == 'fwd' else cin // groups
    bm, bn = tap_tile(rows)
    if mode == 'fwd':
        s, t_min, span, j_min = stride, k, dilation * (k - 1), t_out
    else:
        taps = [t for t in (dx_phase(rho, k, stride, padding, dilation, t_in)[2]
                            for rho in range(stride)) if t > 0]
        s, t_min = 1, min(taps)
        span = (max(taps) - 1) * (dilation // math.gcd(stride, dilation))
        j_min = max(1, t_in // stride)
    nseg = min(n, (bn - 1) // j_min + 2)
    qx = span // s
    lpp = tap_pitch(bn + nseg * qx, s)
    nch = (TAP_BK - 1) // t_min + 2
    stage = -(-(bm * (TAP_BK + 4) + nch * s * lpp + TAP_BK) // 4) * 4
    return dict(tile=(bm, bn), qx=qx, lpp=lpp, ldw=s * lpp, nch=nch, stage=stage,
                smem=4 * (TAP_STAGES * stage + 2 * s * lpp + k))


def dw_tile(rows: int):
    """(rows, columns) of the weight-gradient kernel's block tile for
    ``rows`` output channels per group (``dispatch_dw`` and ``dispatch`` in
    the CUDA source)."""
    for least, tile in ((128, (128, 64)), (64, (64, 64)), (32, (32, 128)),
                        (16, (16, 256)), (2, (8, 256))):
        if rows >= least:
            return tile
    return 1, 32


def dw_scratch(cout: int, cg: int, k: int, groups: int, n: int, t_out: int, splits: int,
               gy_aligned: bool, bf16: bool = False) -> int:
    """Floats of scratch the weight-gradient entry point takes: the splits'
    fp32 partial sums when ``splits`` > 1 or the tensors are bfloat16
    (rounded up to a multiple of 4), then, on the tensor-core kernel when
    gy's rows are not whole pieces of 4 (``t_out % 4``, or gy not aligned to
    16 bytes, bfloat16 8: ``gy_aligned``), gy with its rows zero-padded to a
    multiple of 4, in gy's dtype (``grouped_conv_weight_grad`` in the CUDA
    source)."""
    partials = -(-splits * cout * cg * k // 4) * 4 if splits > 1 or bf16 else 0
    padded = dw_kernel(cout // groups) == 'conv_dw_kernel' and (t_out % 4 or not gy_aligned)
    elems = n * cout * -(-t_out // 4) * 4 if padded else 0
    return partials + (-(-elems // 2) if bf16 else elems)


def dw_splits(cout: int, cg: int, k: int, groups: int, positions: int, sms: int) -> int:
    """Chunks of the weight gradient's reduction over ``positions`` (item,
    time) pairs on a card with ``sms`` SMs: enough blocks to fill it when the
    weight is small (MSD L0 on 132 SMs: one weight tile over 262,144
    positions, 1,024 chunks), few when it is large (MSD L5: 656 tiles, 2)."""
    bm, bn = dw_tile(cout // groups)
    tiles = groups * -(-(cout // groups) // bm) * -(-(cg * k) // bn)
    return max(1, min(-(-DW_BLOCKS_PER_SM * sms // tiles), positions // DW_MIN_CHUNK))


def conv1d_weight_grad(x: torch.Tensor, gy: torch.Tensor, w_shape: Sequence[int], *,
                       stride: int = 1, padding: int = 0, groups: int = 1,
                       dilation: int = 1, precision: str = 'highest') -> torch.Tensor:
    """Weight gradient (C_out, C_in / groups, K) of the conv from its input x
    (N, C_in, T) and cotangent gy (N, C_out, T_out), in their dtype (the
    weight's). The kernel sums the (item, time) reduction in fp32, in fixed
    chunks and a fixed order: a rerun is bit-identical."""
    check_precision(precision)
    if x.device.type == 'cpu':
        return conv1d_weight_grad_reference(x, gy, w_shape, stride=stride,
                                            padding=padding, groups=groups,
                                            dilation=dilation, precision=precision)
    bf16 = _check('conv1d_weight_grad', (x, gy))
    n, cin, t_in = x.shape
    cout, cg, k = (int(s) for s in w_shape)
    if cin != cg * groups or cout % groups or gy.shape[:2] != (n, cout) or \
            conv_out_len(t_in, k, stride, padding, dilation) != gy.shape[2]:
        raise ValueError('conv1d_weight_grad: x %s, gy %s and weight %s do not fit'
                         % (tuple(x.shape), tuple(gy.shape), tuple(w_shape)))
    splits = dw_splits(cout, cg, k, groups, n * gy.shape[2],
                       torch.cuda.get_device_properties(x.device).multi_processor_count)
    dw = torch.empty((cout, cg, k), dtype=x.dtype, device=x.device)
    floats = dw_scratch(cout, cg, k, groups, n, gy.shape[2], splits,
                        gy.data_ptr() % (8 if bf16 else 16) == 0, bf16)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device) if floats else None
    with torch.cuda.device(x.device):
        code = _build.library().grouped_conv_weight_grad(
            x.data_ptr(), gy.data_ptr(), dw.data_ptr(), _ptr(scratch), n, cin, t_in,
            cout, gy.shape[2], k, stride, padding, dilation, groups, splits,
            PRECISIONS.index(precision), bf16, torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'grouped_conv_weight_grad')
    _count(conv1d_weight_grad, precision, bf16)
    return dw


reset_launches()


def _slope_mask(g: torch.Tensor, out: Optional[torch.Tensor],
                slope: Optional[float]) -> torch.Tensor:
    """The cotangent through the fused leaky_relu, from the saved output
    (JAX ``g * where(out > 0, 1, slope)``)."""
    g = g.contiguous()
    return g if slope is None else torch.where(out > 0, g, g * slope)


class _GroupedConv1d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, groups, dilation, slope, precision):
        x, w = x.contiguous(), w.contiguous()
        b = None if b is None else b.contiguous()
        out = conv1d_forward(x, w, b, stride=stride, padding=padding, groups=groups,
                             dilation=dilation, slope=slope, precision=precision)
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x if need_w else None, w if need_x else None,
                              out if slope is not None else None)
        ctx.conf = dict(stride=stride, padding=padding, groups=groups, dilation=dilation,
                        precision=precision)
        ctx.slope, ctx.x_shape, ctx.w_shape = slope, x.shape, w.shape
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        g = _slope_mask(g, out, ctx.slope)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv1d_input_grad(g, w, ctx.x_shape[2], **ctx.conf)
        if ctx.needs_input_grad[1]:
            dw = conv1d_weight_grad(x, g, ctx.w_shape, **ctx.conf)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2), dtype=torch.float32)
        return dx, dw, db, None, None, None, None, None, None


def grouped_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                   *, stride: int = 1, padding: int = 0, groups: int = 1,
                   dilation: int = 1, slope: Optional[float] = None,
                   precision: str = 'highest') -> torch.Tensor:
    """Differentiable grouped conv1d with fused bias + leaky_relu on NCT:
    x (N, C_in, T), w (C_out, C_in / groups, K), b (C_out,) or None ->
    (N, C_out, T_out) in x's dtype (x and w float32, or both bfloat16).
    Forward, dx and dw each run their kernel in ``precision`` on the card
    (:func:`conv1d_forward`, :func:`conv1d_input_grad`,
    :func:`conv1d_weight_grad`), skipping dx or dw when no gradient is asked
    of it; the plain versions of the mode on the CPU. JAX:
    ``grouped_conv1d_ntc``."""
    check_precision(precision)
    return _GroupedConv1d.apply(x, w, b, stride, padding, groups, dilation, slope, precision)


class _ConvTranspose1d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, slope, precision):
        x, w = x.contiguous(), w.contiguous()
        b = None if b is None else b.contiguous()
        t_out = (x.shape[2] - 1) * stride + w.shape[2] - 2 * padding
        out = conv1d_input_grad(x, w, t_out, b, stride=stride, padding=padding,
                                slope=slope, precision=precision)
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x if need_w else None, w if need_x else None,
                              out if slope is not None else None)
        ctx.conf = dict(stride=stride, padding=padding, precision=precision)
        ctx.slope, ctx.w_shape = slope, w.shape
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        g = _slope_mask(g, out, ctx.slope)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:      # the mirror conv's forward
            dx = conv1d_forward(g, w, **ctx.conf)
        if ctx.needs_input_grad[1]:      # its dw, input and cotangent swapped
            dw = conv1d_weight_grad(g, x, ctx.w_shape, **ctx.conf)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2), dtype=torch.float32)
        return dx, dw, db, None, None, None, None


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     *, stride: int = 1, padding: int = 0,
                     slope: Optional[float] = None, precision: str = 'highest'
                     ) -> torch.Tensor:
    """Differentiable ConvTranspose1d on NCT: x (N, C_in, T), w (C_in, C_out,
    K) -> (N, C_out, (T - 1) * stride + K - 2 * padding), then + b and
    leaky_relu when given. Its forward is the input-gradient kernel of the
    mirror conv, its backward the forward kernel (dx) and the weight-gradient
    kernel with input and cotangent swapped (dw), all in ``precision``. JAX:
    ``conv_transpose1d_ntc``."""
    check_precision(precision)
    return _ConvTranspose1d.apply(x, w, b, stride, padding, slope, precision)
