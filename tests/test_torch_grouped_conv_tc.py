"""The grouped-conv forward and dx on the tensor cores (``conv_tap_kernel`` in
``csrc/grouped_conv.cu``) on the CPU: its arithmetic emulated against fp64,
a plain-torch twin of its GEMM decomposition (the window of each column tile
shared by the taps, stored by phase, and dx's per-phase weight gather)
against the plain conv, and its route and tile plan read from the source.

The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
from pytorch_sound_tpu_torch.ops.cuda.k6a_probe import phase8_geometries
from test_torch_grouped_conv import GC_GRAD_TOL, _dw_products
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GC_FWD_TOL = 1e-5       # chip_smoke.py / tests/test_torch_cuda.py: the card's forward vs plain
SOURCE = os.path.join(os.path.dirname(__file__), '..', gc.SOURCE)


def _rel(out, ref):
    return float((out.double() - ref).abs().max() / ref.abs().max())


def _staged_and_chain(a, b):
    """a b^T as the kernel sums it (3xTF32 products rounded toward zero per
    mma, a fresh accumulator per TAP_BK-deep stage added in fp32) and as one
    accumulator chain over the whole reduction would."""
    return {'staged': _dw_products(a, b, gc.TAP_BK), 'chain': _dw_products(a, b, a.shape[-1])}


@pytest.mark.parametrize('cin,k,stride,t_out', [
    (1024, 5, 1, 24),      # MPD conv_4: reduction 1024 x 5
    (128, 41, 1, 24),      # MSD L5: 128 channels per group x 41 taps
])
def test_3xtf32_forward_keeps_the_tolerance(cin, k, stride, t_out):
    """The forward's GEMM (rows: output channels; reduction (ci, m) in the
    kernel's order, 32 per stage; columns (item, time)) with the kernel's
    arithmetic: within GC_FWD_TOL / 10 of fp64, one chain over the whole
    reduction at least 10x further off."""
    rng = np.random.default_rng(k)
    n, cout, pad = 2, 16, k // 2
    t = (t_out - 1) * stride + k - 2 * pad
    x = torch.from_numpy(rng.standard_normal((n, cin, t)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, cin, k)) * (cin * k) ** -0.5)
                         .astype(np.float32))
    ref = gc.grouped_conv1d_reference(x.double(), w.double(), stride=stride, padding=pad)
    # B^T[(n, t), (ci, m)] = x[n, ci, t s + m - pad]
    cols = F.pad(x, (pad, pad)).unfold(2, k, stride)[:, :, :t_out]     # (n, cin, t_out, k)
    cols = cols.permute(0, 2, 1, 3).reshape(n * t_out, cin * k)
    ref = ref.permute(1, 0, 2).reshape(cout, n * t_out)
    err = {name: _rel(out, ref)
           for name, out in _staged_and_chain(w.reshape(cout, cin * k), cols).items()}
    assert err['staged'] <= GC_FWD_TOL / 10, err
    assert err['chain'] >= 10 * err['staged'], err


def test_3xtf32_input_grad_keeps_the_tolerance():
    """dx at an MSD L4-like geometry (stride 4, k 41, groups 8: 11 or 10
    taps per phase, 128 output channels per group): per phase the GEMM of
    the gathered weight [ci][(co, i)] and the cotangent window, with the
    kernel's arithmetic, within GC_GRAD_TOL / 10 of fp64; one chain at
    least 10x further off."""
    rng = np.random.default_rng(4)
    n, cin, cout, k, s, g, pad, t = 2, 64, 1024, 41, 4, 8, 20, 96
    cg, cog = cin // g, cout // g
    t_out = gc.conv_out_len(t, k, s, pad)
    gy = torch.from_numpy(rng.standard_normal((n, cout, t_out)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, cg, k)) * (cog * k / s) ** -0.5)
                         .astype(np.float32))
    ref = gc.conv1d_input_grad_reference(gy.double(), w.double(), t, stride=s, padding=pad,
                                         groups=g)
    outs = {name: torch.zeros(n, cin, t) for name in ('staged', 'chain')}
    taps = set()
    for rho in range(s):
        m0, ms, n_taps, base, dstep, j_count = gc.dx_phase(rho, k, s, pad, 1, t)
        taps.add(n_taps)
        i = torch.arange(n_taps)
        a = w.reshape(g, cog, cg, k)[..., m0 + ms * i]                    # (g, co, ci, i)
        a = a.permute(0, 2, 1, 3).reshape(g, cg, cog * n_taps)
        tt = torch.arange(j_count)[:, None] + base - dstep * i[None]      # (j, i)
        ok = (tt >= 0) & (tt < t_out)
        win = gy.reshape(n, g, cog, t_out)[..., tt.clamp(0, t_out - 1)] * ok
        b = win.permute(1, 0, 3, 2, 4).reshape(g, n * j_count, cog * n_taps)
        for name, out in _staged_and_chain(a, b).items():             # (g, ci, (n, j))
            outs[name][..., rho::s] = out.reshape(g, cg, n, j_count).permute(2, 0, 1, 3) \
                .reshape(n, cin, j_count)
    err = {name: _rel(out, ref) for name, out in outs.items()}
    assert taps == {10, 11}
    assert err['staged'] <= GC_GRAD_TOL / 10, err
    assert err['chain'] >= 10 * err['staged'], err


def _tap_twin(mode, src, w, t_other, *, stride=1, padding=0, dilation=1, groups=1):
    """The tap kernel's GEMM decomposition in plain torch (fp64), block by
    block as ``conv_tap_kernel`` indexes it: each column tile's window of
    the source per channel slot, stored by phase (``tab_n`` / ``tab_u``),
    the taps' entry offsets (``tapoff``), the stage's offsets (``offtab``)
    and the columns' window indices (``colbase``). forward: src = x,
    t_other = t_out; dx: src = gy, t_other = t_in."""
    src, w = src.double(), w.double()
    n, c_src, t_src = src.shape
    cout, cg, k = w.shape
    cog = cout // groups
    if mode == 'fwd':
        cin, t_in, t_out = cg * groups, t_src, t_other
        out = torch.zeros(n, cout, t_out, dtype=torch.float64)
    else:
        cin, t_in, t_out = cg * groups, t_other, t_src
        out = torch.zeros(n, cin, t_in, dtype=torch.float64)
    plan = gc.tap_plan(mode, n, cin, t_in, cout, t_out, k, stride, padding, dilation, groups)
    bm, bn = plan['tile']
    lpp, ldw, qx, nch = plan['lpp'], plan['ldw'], plan['qx'], plan['nch']
    bk = gc.TAP_BK
    for z in range(groups * (1 if mode == 'fwd' else stride)):
        if mode == 'fwd':
            grp, rho = z, 0
            rows, chans, taps, s, jn, off_min = cog, cg, k, stride, t_out, -padding
            a = w[grp * cog:(grp + 1) * cog].reshape(cog, cg * k)          # A[co][(ci, m)]
            rel = [dilation * m for m in range(k)]
        else:
            grp, rho = divmod(z, stride)
            m0, ms, taps, base, dstep, jn = gc.dx_phase(rho, k, stride, padding, dilation,
                                                        t_in)
            rows, chans, s = cg, cog, 1
            off_min = base - (taps - 1) * dstep
            i = torch.arange(taps)
            a = w[grp * cog:(grp + 1) * cog][..., m0 + ms * i]              # (co, ci, i)
            a = a.permute(1, 0, 2).reshape(cg, cog * taps)                # A[ci][(co, i)]
            rel = [(taps - 1 - m) * dstep for m in range(taps)]
        ncols, kk = n * jn, chans * taps
        tapoff = [(r % s) * lpp + r // s for r in rel]
        for c_base in range(0, ncols, bn):
            n0, c_end = c_base // jn, min(c_base + bn, ncols)
            tab = []                       # entry -> (item, position) or None
            for e in range(s * lpp):
                f, idx = divmod(e, lpp)
                n_, col0, sb, hit = n0, c_base, 0, None
                while col0 < c_end:
                    cnt = min((n_ + 1) * jn, c_end) - col0
                    if idx < sb + cnt + qx:
                        u = (col0 - n_ * jn + idx - sb) * s + f + off_min
                        hit = (n_, u) if 0 <= u < t_src else None
                        break
                    sb, col0, n_ = sb + cnt + qx, col0 + cnt, n_ + 1
                tab.append(hit)
            cols = torch.arange(c_base, c_end)
            colbase = cols - c_base + (cols // jn - n0) * qx
            acc = torch.zeros(rows, c_end - c_base, dtype=torch.float64)
            for r0 in range(0, kk, bk):
                c_first = r0 // taps
                win = torch.zeros(nch * ldw, dtype=torch.float64)
                for cs in range((r0 + bk - 1) // taps - c_first + 1):
                    c = c_first + cs
                    if c >= chans:
                        continue
                    for e, hit in enumerate(tab):
                        if hit is not None:
                            win[cs * ldw + e] = src[hit[0], grp * chans + c, hit[1]]
                r = torch.arange(r0, r0 + bk)
                offtab = torch.tensor([(ri // taps - c_first) * ldw + tapoff[ri % taps]
                                       for ri in r.tolist()])
                b = win[offtab[:, None] + colbase[None, :]]                 # (bk, cols)
                a_st = torch.zeros(rows, bk, dtype=torch.float64)
                a_st[:, :max(0, min(bk, kk - r0))] = a[:, r0:r0 + bk]
                acc += a_st @ b
            n_idx, j = cols // jn, cols % jn
            if mode == 'fwd':
                out[n_idx, grp * cog:(grp + 1) * cog, j] = acc.T
            else:
                out[n_idx, grp * cg:(grp + 1) * cg, rho + stride * j] = acc.T
    return out


TWIN_CASES = [
    # (n, cin, cout, k, stride, groups, dilation, padding, t): every phase at
    # strides 1-4 and dilations 1-3, items shorter than a column tile
    (2, 16, 32, 5, 1, 2, 1, 2, 40),
    (2, 32, 16, 7, 2, 2, 1, 3, 37),
    (3, 16, 16, 5, 3, 1, 2, 4, 41),
    (2, 16, 32, 9, 4, 2, 2, 8, 50),
    (2, 16, 16, 3, 2, 1, 3, 3, 29),
    (2, 16, 16, 7, 3, 1, 3, 9, 33),
    (2, 32, 32, 41, 4, 2, 1, 20, 64),
    (40, 16, 16, 5, 3, 1, 1, 2, 11),        # t_out 4: a tile spans ten items
    (2, 16, 32, 16, 8, 1, 1, 4, 40),        # v2's first upsamples' mirror conv (k16 u8)
    (2, 16, 32, 4, 2, 1, 1, 1, 34),         # and its last two (k4 u2)
]


@pytest.mark.parametrize('n,ci,co,k,s,g,d,p,t', TWIN_CASES)
def test_tap_decomposition_matches_the_plain_conv(n, ci, co, k, s, g, d, p, t):
    rng = np.random.default_rng(n + ci + co + k + s + d + t)
    conf = dict(stride=s, padding=p, groups=g, dilation=d)
    t_out = gc.conv_out_len(t, k, s, p, d)
    x = torch.from_numpy(rng.standard_normal((n, ci, t)))
    w = torch.from_numpy(rng.standard_normal((co, ci // g, k)))
    gy = torch.from_numpy(rng.standard_normal((n, co, t_out)))
    y = _tap_twin('fwd', x, w, t_out, **conf)
    dx = _tap_twin('dx', gy, w, t, **conf)
    torch.testing.assert_close(y, gc.grouped_conv1d_reference(x, w, **conf), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(dx, gc.conv1d_input_grad_reference(gy, w, t, **conf),
                               rtol=1e-12, atol=1e-12)


def test_tap_route_follows_the_kernel_source():
    """``fwd_kernel`` / ``dx_kernel``, ``tap_tile``, ``tap_pitch`` and
    ``tap_plan`` against ``csrc/grouped_conv.cu``; every forward and dx of
    phase 8.1's 58 layers at 32 x 8192 on the tensor cores fits a block's
    227 KB at the tile dispatch picks, and the calls below the row or the
    depth threshold are the kinds the kernel leaves to the CUDA cores:
    conv_post (one output channel: its forward has one row, its dx a
    reduction of 3), each critic's first layer (one input channel), v2's
    last upsample's ConvTranspose1d (8 rows)."""
    src = open(SOURCE).read()
    assert 'constexpr int kTapMinRows = %d;' % gc.TC_MIN_ROWS in src
    assert 'constexpr int kTapBK = %d;' % gc.TAP_BK in src
    assert 'constexpr int kTapStages = %d;' % gc.TAP_STAGES in src
    assert 'constexpr int kTapMaxSmem = %d;' % gc.TAP_MAX_SMEM in src
    assert '  if (rows < kTapMinRows) return -1;' in src
    assert 'if (p.depth < kTapBK || p.smem > static_cast<size_t>(kTapMaxSmem)) return -1;' in src
    for rows, depth in ((16, 32), (15, 5120), (1024, 31), (128, 15), (32, 5), (1024, 5120)):
        want = 'conv_tap_kernel' if rows >= 16 and depth >= 32 else 'conv_gemm_kernel'
        assert gc.fwd_kernel(rows, depth) == gc.dx_kernel(rows, depth) == want
    assert 'const int want = s == 2 ? 16 : (s == 3 ? 11 : 8);' in src
    for line in ('const int nseg = std::min(g.n, (bn - 1) / j_min + 2);',
                 'p.qx = span / s;', 'p.lpp = tap_pitch(bn + nseg * p.qx, s);',
                 'p.nch = (kTapBK - 1) / t_min + 2;',
                 'p.stage = (bm * (kTapBK + 4) + p.nch * p.ldw + kTapBK + 3) / 4 * 4;',
                 'p.smem = sizeof(float) * (kTapStages * static_cast<size_t>(p.stage) + 2 * p.ldw'
                 ' + g.k);'):
        assert line in src, line
    body = src[src.index('int dispatch_tap('):]
    body = body[:body.index('#undef PSTT_TAP')]
    rules = re.findall(r'if \(rows >= (\d+)\) PSTT_TAP\((\d+), (\d+),', body)
    last = re.search(r'\n  PSTT_TAP\((\d+), (\d+),', body).groups()
    assert len(rules) == 3
    for rows in (16, 31, 32, 63, 64, 127, 128, 1024):
        want = next(((int(bm), int(bn)) for least, bm, bn in rules if rows >= int(least)),
                    tuple(int(v) for v in last))
        assert gc.tap_tile(rows) == want, rows
    for lp in range(64, 200):
        assert gc.tap_pitch(lp, 1) == lp
        for s, want in ((2, 16), (3, 11), (4, 8), (8, 8)):
            pitch = gc.tap_pitch(lp, s)
            assert lp <= pitch < lp + 32 and pitch % 32 == want

    geoms = phase8_geometries()
    assert len(geoms) == 58
    gemm = []
    for name, n, cin, t_in, cout, k, s, p, d, g in geoms:
        t_out = gc.conv_out_len(t_in, k, s, p, d)
        for mode, rows, depth in (('fwd', cout // g, cin // g * k),
                                  ('dx', cin // g, gc.dx_depth(cout, k, s, p, d, g))):
            kernel = (gc.fwd_kernel if mode == 'fwd' else gc.dx_kernel)(rows, depth)
            if kernel == 'conv_gemm_kernel':
                gemm.append('%s.%s' % (name, mode))
                continue
            plan = gc.tap_plan(mode, n, cin, t_in, cout, t_out, k, s, p, d, g)
            assert plan['smem'] <= gc.TAP_MAX_SMEM, (name, mode, plan)
    first_and_post = ('conv_0.fwd', 'conv_0.dx', 'conv_post.fwd', 'conv_post.dx')
    assert sorted(gemm) == sorted(
        ['mpd.period_%d.%s' % (q, c) for q in (2, 3, 5, 7, 11) for c in first_and_post]
        + ['msd.scale_%d.%s' % (q, c) for q in range(3) for c in first_and_post]
        + ['gen.ups_3.dx'])
