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


def conv_out_len(t_in: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1) -> int:
    return (t_in + 2 * padding - dilation * (kernel_size - 1) - 1) // stride + 1


def grouped_conv1d_reference(x: torch.Tensor, w: torch.Tensor,
                             b: Optional[torch.Tensor] = None, *, stride: int = 1,
                             padding: int = 0, groups: int = 1, dilation: int = 1,
                             slope: Optional[float] = None) -> torch.Tensor:
    """Plain forward: ``F.conv1d`` + bias, then ``F.leaky_relu`` if ``slope``."""
    out = F.conv1d(x, w, b, stride=stride, padding=padding, dilation=dilation,
                   groups=groups)
    return out if slope is None else F.leaky_relu(out, slope)


def conv1d_input_grad_reference(gy: torch.Tensor, w: torch.Tensor, t_in: int, *,
                                stride: int = 1, padding: int = 0, groups: int = 1,
                                dilation: int = 1) -> torch.Tensor:
    """Plain input gradient (N, C_in, t_in) of the conv from its cotangent."""
    size = (gy.shape[0], w.shape[1] * groups, t_in)
    return torch.nn.grad.conv1d_input(size, w, gy, stride, padding, dilation, groups)


def conv1d_weight_grad_reference(x: torch.Tensor, gy: torch.Tensor,
                                 w_shape: Sequence[int], *, stride: int = 1,
                                 padding: int = 0, groups: int = 1,
                                 dilation: int = 1) -> torch.Tensor:
    """Plain weight gradient (C_out, C_in / groups, K) of the conv."""
    return torch.nn.grad.conv1d_weight(x, tuple(w_shape), gy, stride, padding,
                                       dilation, groups)


def conv_transpose1d_reference(x: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor] = None, *, stride: int = 1,
                               padding: int = 0, slope: Optional[float] = None
                               ) -> torch.Tensor:
    """Plain ConvTranspose1d, w (C_in, C_out, K), then leaky_relu if ``slope``."""
    out = F.conv_transpose1d(x, w, b, stride=stride, padding=padding)
    return out if slope is None else F.leaky_relu(out, slope)


def _epilogue(out: torch.Tensor, b: Optional[torch.Tensor],
              slope: Optional[float]) -> torch.Tensor:
    if b is not None:
        out = out + b[None, :, None]
    return out if slope is None else F.leaky_relu(out, slope)


def _check(name: str, *tensors):
    """The kernels take contiguous float32 tensors on one CUDA device."""
    dev = tensors[0].device
    if dev.type != 'cuda':
        raise RuntimeError('%s runs on cpu or cuda, not %s' % (name, dev))
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError('%s kernel takes contiguous float32 tensors on %s, got '
                             '%s %s on %s' % (name, dev, t.dtype, tuple(t.shape), t.device))


def _geometry(name: str, n: int, cin: int, cout: int, w: torch.Tensor, groups: int):
    cout_w, cg, _ = w.shape
    if groups < 1 or cin != cg * groups or cout != cout_w or cout % groups:
        raise ValueError('%s: weight %s does not fit %d -> %d channels in %d groups'
                         % (name, tuple(w.shape), cin, cout, groups))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def conv1d_forward(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                   *, stride: int = 1, padding: int = 0, groups: int = 1,
                   dilation: int = 1, slope: Optional[float] = None) -> torch.Tensor:
    """x (N, C_in, T) -> leaky_relu(conv1d(x, w) + b) (N, C_out, T_out); w
    (C_out, C_in / groups, K). The kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if x.device.type == 'cpu':
        return grouped_conv1d_reference(x, w, b, stride=stride, padding=padding,
                                        groups=groups, dilation=dilation, slope=slope)
    _check('conv1d_forward', x, w, b)
    n, cin, t_in = x.shape
    cout, _, k = w.shape
    _geometry('conv1d_forward', n, cin, cout, w, groups)
    t_out = conv_out_len(t_in, k, stride, padding, dilation)
    if t_out < 1:
        raise ValueError('conv1d_forward: input of %d samples is shorter than the kernel'
                         % t_in)
    y = torch.empty((n, cout, t_out), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _build.library().grouped_conv_forward(
            x.data_ptr(), w.data_ptr(), _ptr(b), y.data_ptr(), n, cin, t_in, cout,
            t_out, k, stride, padding, dilation, groups, slope is not None,
            slope or 0.0, torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'grouped_conv_forward')
    conv1d_forward.launches += 1
    return y


conv1d_forward.launches = 0


def conv1d_input_grad(gy: torch.Tensor, w: torch.Tensor, t_in: int,
                      b: Optional[torch.Tensor] = None, *, stride: int = 1,
                      padding: int = 0, groups: int = 1, dilation: int = 1,
                      slope: Optional[float] = None) -> torch.Tensor:
    """Input gradient (N, C_in, t_in) of the conv from gy (N, C_out, T_out),
    then ``+ b`` (C_in,) and leaky_relu when given. With groups 1 and
    dilation 1 this is ConvTranspose1d of gy with weight w (C_out, C_in, K)."""
    if gy.device.type == 'cpu':
        dx = conv1d_input_grad_reference(gy, w, t_in, stride=stride, padding=padding,
                                         groups=groups, dilation=dilation)
        return _epilogue(dx, b, slope)
    _check('conv1d_input_grad', gy, w, b)
    n, cout, t_out = gy.shape
    _, cg, k = w.shape
    cin = cg * groups
    _geometry('conv1d_input_grad', n, cin, cout, w, groups)
    if t_in < 1 or conv_out_len(t_in, k, stride, padding, dilation) != t_out:
        raise ValueError('conv1d_input_grad: %d input samples do not give %d outputs'
                         % (t_in, t_out))
    dx = torch.empty((n, cin, t_in), dtype=torch.float32, device=gy.device)
    with torch.cuda.device(gy.device):
        code = _build.library().grouped_conv_input_grad(
            gy.data_ptr(), w.data_ptr(), _ptr(b), dx.data_ptr(), n, cin, t_in, cout,
            t_out, k, stride, padding, dilation, groups, slope is not None,
            slope or 0.0, torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'grouped_conv_input_grad')
    conv1d_input_grad.launches += 1
    return dx


conv1d_input_grad.launches = 0


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
               gy_aligned: bool) -> int:
    """Floats of scratch the weight-gradient entry point takes: the splits'
    partial sums when ``splits`` > 1 (rounded up to a multiple of 4), then,
    on the tensor-core kernel when gy's rows are not whole 16-byte pieces
    (``t_out % 4`` or a misaligned gy), gy with its rows zero-padded to a
    multiple of 4 (``grouped_conv_weight_grad`` in the CUDA source)."""
    partials = -(-splits * cout * cg * k // 4) * 4 if splits > 1 else 0
    padded = dw_kernel(cout // groups) == 'conv_dw_kernel' and (t_out % 4 or not gy_aligned)
    return partials + (n * cout * -(-t_out // 4) * 4 if padded else 0)


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
                       dilation: int = 1) -> torch.Tensor:
    """Weight gradient (C_out, C_in / groups, K) of the conv from its input x
    (N, C_in, T) and cotangent gy (N, C_out, T_out). The kernel sums the
    (item, time) reduction in fixed chunks and a fixed order: a rerun is
    bit-identical."""
    if x.device.type == 'cpu':
        return conv1d_weight_grad_reference(x, gy, w_shape, stride=stride,
                                            padding=padding, groups=groups,
                                            dilation=dilation)
    _check('conv1d_weight_grad', x, gy)
    n, cin, t_in = x.shape
    cout, cg, k = (int(s) for s in w_shape)
    if cin != cg * groups or cout % groups or gy.shape[:2] != (n, cout) or \
            conv_out_len(t_in, k, stride, padding, dilation) != gy.shape[2]:
        raise ValueError('conv1d_weight_grad: x %s, gy %s and weight %s do not fit'
                         % (tuple(x.shape), tuple(gy.shape), tuple(w_shape)))
    splits = dw_splits(cout, cg, k, groups, n * gy.shape[2],
                       torch.cuda.get_device_properties(x.device).multi_processor_count)
    dw = torch.empty((cout, cg, k), dtype=torch.float32, device=x.device)
    floats = dw_scratch(cout, cg, k, groups, n, gy.shape[2], splits, gy.data_ptr() % 16 == 0)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device) if floats else None
    with torch.cuda.device(x.device):
        code = _build.library().grouped_conv_weight_grad(
            x.data_ptr(), gy.data_ptr(), dw.data_ptr(), _ptr(scratch), n, cin, t_in,
            cout, gy.shape[2], k, stride, padding, dilation, groups, splits,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'grouped_conv_weight_grad')
    conv1d_weight_grad.launches += 1
    return dw


conv1d_weight_grad.launches = 0


def _slope_mask(g: torch.Tensor, out: Optional[torch.Tensor],
                slope: Optional[float]) -> torch.Tensor:
    """The cotangent through the fused leaky_relu, from the saved output
    (JAX ``g * where(out > 0, 1, slope)``)."""
    g = g.contiguous()
    return g if slope is None else torch.where(out > 0, g, g * slope)


class _GroupedConv1d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, groups, dilation, slope):
        x, w = x.contiguous(), w.contiguous()
        b = None if b is None else b.contiguous()
        out = conv1d_forward(x, w, b, stride=stride, padding=padding, groups=groups,
                             dilation=dilation, slope=slope)
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x if need_w else None, w if need_x else None,
                              out if slope is not None else None)
        ctx.conf = dict(stride=stride, padding=padding, groups=groups, dilation=dilation)
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
            db = g.sum(dim=(0, 2))
        return dx, dw, db, None, None, None, None, None


def grouped_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                   *, stride: int = 1, padding: int = 0, groups: int = 1,
                   dilation: int = 1, slope: Optional[float] = None) -> torch.Tensor:
    """Differentiable grouped conv1d with fused bias + leaky_relu on NCT:
    x (N, C_in, T), w (C_out, C_in / groups, K), b (C_out,) or None ->
    (N, C_out, T_out). Forward, dx and dw each run their kernel on the card
    (:func:`conv1d_forward`, :func:`conv1d_input_grad`,
    :func:`conv1d_weight_grad`), skipping dx or dw when no gradient is asked
    of it; the plain versions on the CPU. JAX: ``grouped_conv1d_ntc``."""
    return _GroupedConv1d.apply(x, w, b, stride, padding, groups, dilation, slope)


class _ConvTranspose1d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, slope):
        x, w = x.contiguous(), w.contiguous()
        b = None if b is None else b.contiguous()
        t_out = (x.shape[2] - 1) * stride + w.shape[2] - 2 * padding
        out = conv1d_input_grad(x, w, t_out, b, stride=stride, padding=padding,
                                slope=slope)
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x if need_w else None, w if need_x else None,
                              out if slope is not None else None)
        ctx.stride, ctx.padding, ctx.slope, ctx.w_shape = stride, padding, slope, w.shape
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        g = _slope_mask(g, out, ctx.slope)
        conf = dict(stride=ctx.stride, padding=ctx.padding)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:      # the mirror conv's forward
            dx = conv1d_forward(g, w, **conf)
        if ctx.needs_input_grad[1]:      # its dw, input and cotangent swapped
            dw = conv1d_weight_grad(g, x, ctx.w_shape, **conf)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2))
        return dx, dw, db, None, None, None


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     *, stride: int = 1, padding: int = 0,
                     slope: Optional[float] = None) -> torch.Tensor:
    """Differentiable ConvTranspose1d on NCT: x (N, C_in, T), w (C_in, C_out,
    K) -> (N, C_out, (T - 1) * stride + K - 2 * padding), then + b and
    leaky_relu when given. Its forward is the input-gradient kernel of the
    mirror conv, its backward the forward kernel (dx) and the weight-gradient
    kernel with input and cotangent swapped (dw). JAX:
    ``conv_transpose1d_ntc``."""
    return _ConvTranspose1d.apply(x, w, b, stride, padding, slope)
