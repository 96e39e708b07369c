"""The port's grouped-conv ops (K6, ``ops/cuda/grouped_conv.py``) against the
JAX package's kernel route on the CPU.

The port runs its CPU route: the autograd functions over the plain versions
of the forward, dx and dw entry points, the same split the card runs with the
kernels. The JAX side runs ``grouped_conv1d_ntc`` / ``conv_transpose1d_ntc``
with ``interpret=True``: the Pallas kernel in interpret mode where its
``eligible()`` admits the geometry, XLA's conv where it does not (one input
or output channel). Inputs are made from a numpy seed; the JAX layout is
NTC, the port's NCT. Tolerances are the JAX test's (tests/test_grouped_conv.py:
2e-5 forward, 3e-4 for dx, dw and db).
"""

import os
import re

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pytorch_sound_tpu.ops.pallas.grouped_conv import (  # noqa: E402
    conv_transpose1d_ntc, grouped_conv1d_ntc)
from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc  # noqa: E402
from test_torch_flash_backward import _kernel_products  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

SLOPE = 0.1
FWD_TOL = 2e-5
GRAD_TOL = 3e-4
GC_GRAD_TOL = 1e-4      # chip_smoke.py / tests/test_torch_cuda.py: the card's dw vs plain, ratio to max abs


def _make(shape_x, shape_w, n_bias, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape_x) * 0.5).astype(np.float32)
    w = (rng.standard_normal(shape_w) * 0.1).astype(np.float32)
    b = (rng.standard_normal(n_bias) * 0.1).astype(np.float32)
    return x, w, b


def _torch_grads(fn, x, w, b):
    """(out, (dx, dw, db)) of sum(sin(fn(x, w, b))) through the port (NCT)."""
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out = fn(xt, wt, bt)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), (xt.grad.numpy(), wt.grad.numpy(), bt.grad.numpy())


def _jax_grads(fn, x_ntc, w, b):
    """(out, (dx, dw, db)) of sum(sin(fn(x, w, b))) through JAX (NTC)."""
    args = tuple(jnp.asarray(a) for a in (x_ntc, w, b))
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), tuple(np.asarray(g) for g in vjp(jnp.cos(out)))


def _assert_match(out, grads, ref_out, ref_grads):
    np.testing.assert_allclose(out, ref_out.swapaxes(1, 2), atol=FWD_TOL, rtol=0)
    dx, dw, db = grads
    rdx, rdw, rdb = ref_grads
    for name, a, r in (('dx', dx, rdx.swapaxes(1, 2)), ('dw', dw, rdw), ('db', db, rdb)):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, atol=GRAD_TOL, rtol=0, err_msg=name)


CASES = [
    # (cin, cout, K, stride, groups, dilation, T, slope): the JAX test's
    # geometry classes at small T, then the critics' edge layers
    (64, 64, 41, 2, 4, 1, 128, SLOPE),     # grouped k41, stride 2 (MSD L1)
    (64, 128, 41, 4, 8, 1, 128, SLOPE),    # grouped k41, stride 4 (MSD L3, L4)
    (128, 128, 41, 1, 8, 1, 48, SLOPE),    # grouped k41, stride 1 (MSD L5)
    (64, 64, 5, 1, 1, 1, 64, SLOPE),       # dense k5 (MSD L6, MPD L4)
    (64, 64, 15, 1, 1, 1, 96, SLOPE),      # dense k15
    (96, 48, 7, 3, 4, 1, 99, SLOPE),       # stride 3, odd T
    (64, 64, 3, 1, 1, 3, 128, SLOPE),      # dilated
    (64, 128, 41, 2, 8, 2, 128, SLOPE),    # grouped + dilated
    (1, 32, 15, 1, 1, 1, 100, SLOPE),      # cin = 1 (MSD L0)
    (1, 16, 5, 3, 1, 1, 99, SLOPE),        # cin = 1, k5 s3 (MPD L0)
    (16, 32, 5, 3, 1, 1, 101, SLOPE),      # the MPD's k5 s3 body layers
    (64, 1, 3, 1, 1, 1, 37, None),         # cout = 1 (conv_post), no slope
]


@pytest.mark.parametrize('ci,co,k,s,g,d,t,slope', CASES)
def test_grouped_conv_matches_jax(ci, co, k, s, g, d, t, slope):
    pad = d * (k - 1) // 2
    x, w, b = _make((2, ci, t), (co, ci // g, k), co, seed=ci + co + k + t)
    conf = dict(stride=s, padding=pad, groups=g, dilation=d, slope=slope)
    out, grads = _torch_grads(lambda *a: gc.grouped_conv1d(*a, **conf), x, w, b)
    ref_out, ref_grads = _jax_grads(
        lambda *a: grouped_conv1d_ntc(*a, precision='highest', interpret=True, **conf),
        x.swapaxes(1, 2), w, b)
    _assert_match(out, grads, ref_out, ref_grads)


@pytest.mark.parametrize('ci,co,k,s,p,t', [
    (128, 64, 16, 8, 4, 16),   # HiFi-GAN v2's upsamplers (tests/test_grouped_conv.py:194)
    (64, 32, 16, 8, 4, 24),
    (32, 16, 4, 2, 1, 64),
])
def test_conv_transpose_matches_jax(ci, co, k, s, p, t):
    x, w, b = _make((2, ci, t), (ci, co, k), co, seed=7 + k)
    out, grads = _torch_grads(
        lambda *a: gc.conv_transpose1d(*a, stride=s, padding=p, slope=SLOPE), x, w, b)
    ref_out, ref_grads = _jax_grads(
        lambda *a: conv_transpose1d_ntc(*a, stride=s, padding=p, slope=SLOPE,
                                        precision='highest', interpret=True),
        x.swapaxes(1, 2), w, b)
    _assert_match(out, grads, ref_out, ref_grads)


def test_backward_skips_what_no_one_asks_for(monkeypatch):
    """dx only when the input asks for a gradient, dw only when the weight
    does (the critic phase's first layers, the generator phase's frozen
    critics); the plain versions stand in for the kernels on the CPU."""
    calls = []
    for name in ('conv1d_input_grad_reference', 'conv1d_weight_grad_reference'):
        real = getattr(gc, name)
        monkeypatch.setattr(gc, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    x0, w0, b0 = (torch.from_numpy(a) for a in _make((2, 8, 40), (16, 2, 5), 16, 3))
    for need_x, need_w, want in ((False, True, ['conv1d_weight_grad_reference']),
                                 (True, False, ['conv1d_input_grad_reference']),
                                 (True, True, ['conv1d_input_grad_reference',
                                               'conv1d_weight_grad_reference'])):
        calls.clear()
        x, w = x0.clone().requires_grad_(need_x), w0.clone().requires_grad_(need_w)
        out = gc.grouped_conv1d(x, w, b0, stride=2, padding=2, groups=4, slope=SLOPE)
        out.sum().backward()
        assert calls == want, (need_x, need_w, calls)
        assert (x.grad is not None) == need_x and (w.grad is not None) == need_w


def test_cpu_route_launches_nothing_and_other_devices_raise():
    x, w, b = (torch.from_numpy(a) for a in _make((1, 4, 16), (4, 4, 3), 4, 5))
    before = (gc.conv1d_forward.launches, gc.conv1d_input_grad.launches,
              gc.conv1d_weight_grad.launches)
    xg = x.clone().requires_grad_(True)
    gc.grouped_conv1d(xg, w.requires_grad_(True), b, padding=1, slope=SLOPE).sum().backward()
    assert (gc.conv1d_forward.launches, gc.conv1d_input_grad.launches,
            gc.conv1d_weight_grad.launches) == before
    meta = torch.empty((1, 4, 16), device='meta')
    with pytest.raises(RuntimeError, match='cpu or cuda'):
        gc.conv1d_forward(meta, w.to('meta'))


def test_weight_grad_split_plan():
    """The dw reduction is cut into enough chunks to fill the card when the
    weight is small, and little when it is large; the tile and the kernel
    follow the rows per group, the tensor-core kernel from DW_TC_MIN_ROWS on
    (its tiles 128 x 64 to 16 x 256), the CUDA-core one below (8 x 256, and
    1 x 32 for conv_post's one row)."""
    tiles = {1024: (128, 64), 128: (128, 64), 127: (64, 64), 64: (64, 64), 32: (32, 128),
             16: (16, 256), 15: (8, 256), 2: (8, 256), 1: (1, 32)}
    for rows, tile in tiles.items():
        assert gc.dw_tile(rows) == tile, rows
        assert gc.dw_kernel(rows) == ('conv_dw_kernel' if rows >= 16 else 'conv_gemm_kernel')
    assert gc.DW_TC_MIN_ROWS == 16
    sms = 132                                                     # H100 SXM
    assert gc.dw_splits(128, 1, 15, 1, 32 * 8192, sms) == 1024    # MSD L0: 1 tile
    assert gc.dw_splits(1024, 128, 41, 8, 32 * 128, sms) == 2     # MSD L5: 656 tiles
    assert gc.dw_splits(256, 16, 41, 8, 32 * 4096, sms) == 22     # MSD L2: 48 tiles of 32 x 128
    assert gc.dw_splits(64, 8, 41, 4, 4096, sms) == 16            # 16 rows: 8 tiles, short
    assert gc.dw_splits(32, 1, 5, 1, 352 * 249, sms) == 342       # MPD L0 at p = 11
    assert gc.dw_splits(1, 1024, 3, 1, 32 * 128, sms) == 11       # conv_post: 96 tiles of 1 x 32
    assert gc.dw_splits(32, 1, 5, 1, 100, sms) == 1               # short: one chunk
    # scratch: the partial sums (rounded up to 4 floats), then gy padded to
    # whole 16-byte rows on the tensor-core route where t_out % 4 or gy's
    # address asks for it
    assert gc.dw_scratch(1024, 128, 41, 8, 32, 128, 2, True) == 2 * 1024 * 128 * 41
    assert gc.dw_scratch(1024, 1024, 5, 1, 64, 51, 1, True) == 64 * 1024 * 52
    assert gc.dw_scratch(17, 3, 5, 1, 2, 301, 2, True) == 512 + 2 * 17 * 304
    assert gc.dw_scratch(64, 64, 41, 4, 2, 500, 1, False) == 2 * 64 * 500
    assert gc.dw_scratch(1, 1024, 3, 1, 32, 129, 8, False) == 8 * 3072   # CUDA cores: no pad
    # bfloat16 tensors: the fp32 sums always staged (one split too), gy
    # padded in bf16 (two to a float) where t_out % 4 or its 8-byte address asks
    assert gc.dw_scratch(1024, 1024, 5, 1, 64, 51, 1, True, True) == \
        1024 * 1024 * 5 + 64 * 1024 * 52 // 2
    assert gc.dw_scratch(17, 3, 5, 1, 1, 301, 1, True, True) == 256 + 17 * 304 // 2
    assert gc.dw_scratch(64, 64, 41, 4, 2, 500, 1, True, True) == 64 * 64 * 41
    assert gc.dw_scratch(1, 1024, 3, 1, 32, 129, 8, False, True) == 8 * 3072


def test_weight_grad_route_follows_the_kernel_source():
    """``dw_kernel``, ``dw_tile`` and ``dw_scratch`` against
    ``csrc/grouped_conv.cu``: the row threshold of the tensor-core route,
    its tiles by rows, and when and where it pads gy in scratch."""
    src = open(os.path.join(os.path.dirname(__file__), '..', gc.SOURCE)).read()
    assert 'constexpr int kDwMinRows = %d;' % gc.DW_TC_MIN_ROWS in src
    assert 'const bool tc = cout / groups >= kDwMinRows;' in src
    assert 'const int piece = bf16 ? 8 : 16;  // bytes of gy\'s row copies (4 elements)' in src
    assert ('const bool padded = tc && (t_out % 4 != 0 || '
            'reinterpret_cast<uintptr_t>(gy) % piece != 0);') in src
    assert 'const bool staged = splits > 1 || bf16;' in src
    assert 'float* gyp = scratch + (staged ? (splits * count + 3) / 4 * 4 : 0);' in src
    assert 'if (padded) ga.t_out = (t_out + 3) / 4 * 4;' in src
    body = src[src.index('int dispatch_dw('):]
    rules = re.findall(r'if \(rows >= (\d+)\) return launch_dw<(\d+), (\d+),', body[:800])
    last = re.search(r'\n  return launch_dw<(\d+), (\d+),', body).groups()
    for rows in (16, 31, 32, 63, 64, 127, 128, 1024):
        want = next(((int(bm), int(bn)) for least, bm, bn in rules if rows >= int(least)),
                    tuple(int(v) for v in last))
        assert gc.dw_tile(rows) == want, rows


def _dw_products(a, b, tile):
    """a b^T over the last axis (positions) as conv_dw_kernel sums it:
    operands split as split_tf32 does, three m16n8k8 products per 8-deep
    step rounded toward zero into one accumulator per ``tile`` positions
    (``tile`` = all positions: one chain), each tile added in fp32."""
    out = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for c in range(0, a.shape[-1], tile):
        out = out + _kernel_products(a[..., c:c + tile], b[..., c:c + tile], False)
    return out


def test_3xtf32_weight_grad_keeps_the_tolerance():
    """dw at an MSD-like grouped geometry (k 41, stride 4, groups 4, 16 rows
    per group, 4,096 positions) with the tensor-core kernel's arithmetic
    emulated: 3xTF32 products of split_tf32 operands rounded toward zero
    per mma, a fresh accumulator per 32-position stage added in fp32, the
    card's split plan summed in split order. Within GC_GRAD_TOL / 10 of the
    fp64 weight gradient (measured 3.7e-7 of its max abs); one accumulator
    chain over all 4,096 positions lies 4.3e-5 off, over 100x further."""
    rng = np.random.default_rng(41)
    n, cin, cout, k, s, g, pad, t = 2, 32, 64, 41, 4, 4, 20, 8192
    x = torch.from_numpy(rng.standard_normal((n, cin, t)).astype(np.float32))
    t_out = gc.conv_out_len(t, k, s, pad)
    gy = torch.from_numpy(rng.standard_normal((n, cout, t_out)).astype(np.float32))
    ref = gc.conv1d_weight_grad_reference(x.double(), gy.double(), (cout, cin // g, k),
                                          stride=s, padding=pad, groups=g)
    # im2col: cols[g][(ci, m), (n, t)] = x[n, g cg + ci, t s + m - pad]
    patches = F.pad(x, (pad, pad)).unfold(2, k, s)[:, :, :t_out]     # (n, cin, t_out, k)
    cols = patches.reshape(n, g, cin // g, t_out, k).permute(1, 2, 4, 0, 3)
    cols = cols.reshape(g, (cin // g) * k, n * t_out)
    rows = gy.reshape(n, g, cout // g, t_out).permute(1, 2, 0, 3).reshape(g, cout // g, -1)
    positions = n * t_out
    splits = gc.dw_splits(cout, cin // g, k, g, positions, 132)
    chunk = -(-(-(-positions // splits)) // 32) * 32
    staged = sum(_dw_products(rows[..., c:c + chunk], cols[..., c:c + chunk], 32)
                 for c in range(0, positions, chunk))
    chain = _dw_products(rows, cols, positions)
    err = {}
    for name, dw in (('staged', staged), ('chain', chain)):
        dw = dw.reshape(g, cout // g, cin // g, k).reshape(cout, cin // g, k)
        err[name] = float((dw.double() - ref).abs().max() / ref.abs().max())
    assert splits > 1 and err['staged'] <= GC_GRAD_TOL / 10, err
    assert err['chain'] >= 10 * err['staged'], err
