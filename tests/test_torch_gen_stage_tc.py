"""What the stage kernel's tensor-core convs (``csrc/gen_stage.cu``: the
resblock convs of K1 and K3, and K1's transposed conv) rest on, checked on
the CPU:

- that their arithmetic keeps the stage tolerance: an emulation of the
  kernel's 3xTF32 products (split_tf32 operands, each mma rounded toward
  zero into its accumulator, a fresh accumulator per run of products as
  each layout sums them, the block's own channel slice first) on a
  ResBlock1 stack at C = 256, k = 11, against fp64, beside one TF32 pass
  and one accumulator chain;
- that the kernel's tiling, read from its source, does what its note says:
  the time tile each width gets from ``plan_tile``'s reckoning (and what a
  padded row stride would cost), conflict-free fragment loads and stores
  under the row swizzle and the input span's row stride, the n-tile route
  of each width, one wave per conv in the cluster layout, and every output
  of a conv computed by exactly one lane;
- that ``tf32_fragments`` lays the weight out as the kernel reads it;
- the same for the bf16 modes ('bf16x3', 'default': mma m16n8k16): an
  emulation of their sums against the plain version at the tolerances
  chip_smoke.py holds the kernel to, conflict-free loads of their A
  fragments (rows t, t + 4, t + 8, t + 12), and ``bf16_fragments`` as the
  B operand that, with those A rows, computes the conv.

The kernel itself runs on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch.ops.cuda import gen_stage as gs

STAGE_TOL = 2e-5     # chip_smoke.py / tests/test_torch_cuda.py: one stage vs plain
BF16X3_TOL = 2 ** -16        # chip_smoke.py: 'bf16x3' stage vs plain, of its max abs
DEFAULT_STAGE_TOL = 2 ** -7  # chip_smoke.py: 'default' stage vs plain, of its max abs
SMEM_LIMIT = 232448  # the H100's shared memory per block (227 KB, opt-in)
SRC = open(os.path.join(os.path.dirname(__file__), '..', gs.SOURCE)).read()
CONST = {name: int(val) for name, val in re.findall(r'constexpr int (\w+) = (\d+);', SRC)}


def _trunc(x):
    """What the tensor cores read of a TF32 operand: the top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """split_tf32: hi = x + half a TF32 ulp, lo = x - hi, both read truncated."""
    hi = _trunc((x.view(torch.int32) + 0x1000).view(torch.float32))
    return hi, _trunc(x - hi)


def _round_to_zero(d):
    f = d.float()
    return torch.where(f.double().abs() > d.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _lrelu(x):
    return torch.where(x > 0, x, x * 0.1)


def _conv_emulated(x, w, b, d, mode, slice_=32):
    """One resblock conv of x (C, P) with zero padding, as the kernel sums
    it, the output slice's own 16-channel chunks first, then tap by tap:
    'cluster' (each tap of a chunk, two k-steps, in a run accumulator added
    to the fp32 total), 'single' (each k-step's three products in a fresh
    accumulator added to the total), 'chain' (one accumulator for all), or
    'tf32' (one TF32 pass, exact sums)."""
    c, p = x.shape
    k = w.shape[2]
    pad = (k - 1) // 2 * d
    xp = F.pad(x, (pad, pad))
    if mode == 'tf32':
        hi = _trunc((xp.view(torch.int32) + 0x1000).view(torch.float32)).double()
        wh = _trunc((w.view(torch.int32) + 0x1000).view(torch.float32)).double()
        return F.conv1d(hi[None], wh, dilation=d)[0].float() + b[:, None]
    kc = CONST['kKC']
    taps = [_split(xp[:, j * d:j * d + p]) for j in range(k)]
    wh, wl = _split(w)
    out = torch.zeros((c, p))
    for r0 in range(0, c, slice_):                       # one block's output slice
        rows = slice(r0, r0 + slice_)
        chunks = list(range(0, c, kc))
        chunks = chunks[r0 // kc:] + chunks[:r0 // kc]   # its own chunks first
        total = torch.zeros((slice_, p))
        acc = torch.zeros((slice_, p))
        for c0 in chunks:
            for j, (ah, al) in enumerate(taps):
                part = acc if mode == 'chain' else torch.zeros((slice_, p))
                for s in range(c0, c0 + kc, 8):
                    if mode == 'single':
                        part = torch.zeros((slice_, p))
                    for a, bw in ((al, wh), (ah, wl), (ah, wh)):
                        part = _round_to_zero(part.double() + bw[rows, s:s + 8, j].double()
                                              @ a[s:s + 8].double())
                    if mode == 'single':
                        total = total + part
                if mode == 'chain':
                    acc = part
                elif mode == 'cluster':
                    total = total + part
        out[rows] = (acc if mode == 'chain' else total) + b[rows, None]
    return out


def _resblock(x, convs, conv):
    for (w1, b1, d1), (w2, b2, d2) in zip(convs[0::2], convs[1::2]):
        xt = conv(_lrelu(x), w1, b1, d1)
        x = conv(_lrelu(xt), w2, b2, d2) + x
    return x


@pytest.mark.parametrize('mode', ['cluster', 'single', 'tf32', 'chain'])
def test_3xtf32_keeps_the_stage_tolerance(mode):
    """A ResBlock1 stack at C = 256, k = 11, dilations 1 / 3 / 5 (v1's
    widest convs) over 64 positions, against fp64, relative to its max abs:
    the kernel's sums measured 4.0e-7 with the cluster layout's runs (a tap
    of a 16-channel chunk) and 4.2e-7 with the single-block layout's (a
    k-step; held here at C = 256 too), the fp32 plain version 3.5e-7, all
    within STAGE_TOL / 2;
    one TF32 pass 2.8e-4 and one accumulator chain over every tap and
    channel 3.9e-5, both outside it, so the tolerance tells them apart and
    the chain would not keep it."""
    rng = np.random.default_rng(0)
    c, k = 256, 11
    convs = [(torch.from_numpy((rng.standard_normal((c, c, k)) / np.sqrt(c * k))
                               .astype(np.float32)),
              torch.from_numpy((rng.standard_normal(c) * 0.05).astype(np.float32)), dil)
             for d in (1, 3, 5) for dil in (d, 1)]
    x = torch.from_numpy(rng.standard_normal((c, 64)).astype(np.float32))
    ref = _resblock(x.double(), [(w.double(), b.double(), d) for w, b, d in convs],
                    lambda v, w, b, d: F.conv1d(v[None], w, b, padding=(k - 1) // 2 * d,
                                                dilation=d)[0])
    got = _resblock(x, convs, lambda v, w, b, d: _conv_emulated(v, w, b, d, mode))
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    if mode in ('cluster', 'single'):
        assert err <= STAGE_TOL / 2, err
    else:
        assert err > STAGE_TOL / 2 if mode == 'chain' else err > STAGE_TOL, (mode, err)


def _swz(row):
    expr = re.search(r'int swz\(int row\) \{ return (.*?); \}', SRC).group(1)
    return eval(expr, {'row': row})


def _q_row(q_stride):
    expr = re.search(r's\.q_row = s\.q_stride \+ (.*?);', SRC).group(1)
    return q_stride + eval(expr.replace('s.q_stride', 'q'), {'q': q_stride})


def _plan_bytes(c, tile, ranks, k_up=0, u=1, post_k=0, pre=None, stride=0):
    """plan_tile's reckoning in bytes (0: the halo does not hold a block's
    reach), at row stride L + stride (the kernel's is L: stride 0)."""
    halo = CONST['kHalo']
    L = tile + 2 * halo + stride
    ph = (post_k - 1) // 2 if post_k else 0
    a_lo, a_hi = halo - ph, halo + tile + ph
    h_lo, h_hi = a_lo, a_hi
    for k, dils in zip((3, 7, 11), ((1, 3, 5),) * 3):
        reach = sum((k - 1) // 2 * d + (k - 1) // 2 for d in dils)
        h_lo, h_hi = min(h_lo, a_lo - reach), max(h_hi, a_hi + reach)
    if h_lo < 0 or h_hi > tile + 2 * halo:
        return 0
    cs = c // ranks
    bufs = (3 * L + (a_hi - a_lo)) * cs + (2 * CONST['kKC'] * L if ranks > 1 else 0)
    if not k_up:
        return 4 * bufs
    pad = (k_up - u) // 2
    m_taps = -(-k_up // u)
    q_stride = (h_hi - 1 + pad) // u - (h_lo + pad) // u + m_taps
    mel = pre[0] * (q_stride + pre[1] - 1) if pre else 0
    xs_off = max(2 * cs * L, mel)
    return 4 * max(bufs, xs_off + 2 * c * _q_row(q_stride))


def _tile(c, stride=0, **geom):
    """The widest tile launch() takes: 1024 ... 64, at most kWideMaxTile in
    the cluster layout, whose buffers fit a block."""
    ranks = 1 if c <= 64 else c // CONST['kSlice']
    t = CONST['kWideMaxTile'] if ranks > 1 else 1024
    while t >= CONST['kHalo']:
        if 0 < _plan_bytes(c, t, ranks, stride=stride, **geom) <= SMEM_LIMIT:
            return t
        t //= 2
    return 0


def test_plan_tile_follows_the_kernel_source():
    """The reckoning this twin repeats is the source's."""
    assert 'const size_t bufs = (3 * static_cast<size_t>(L) + A) * cs +' in SRC
    assert '(plan.ranks > 1 ? 2 * kKC * static_cast<size_t>(L) : 0);' in SRC
    assert 'xs_off + 2 * static_cast<size_t>(s.c) * s.q_row) * sizeof(float)' in SRC
    assert 'for (int t = wide ? kWideMaxTile : 1024; t >= kHalo; t /= 2) {' in SRC


@pytest.mark.parametrize('c,geom,tile', [
    (64, dict(k_up=16, u=8), 128),            # v2 stage 0, v1 stage 2
    (32, dict(k_up=16, u=8), 256),            # v2 stage 1
    (16, dict(k_up=4, u=2), 512),             # v2 stage 2
    (8, dict(k_up=4, u=2, post_k=7), 1024),   # v2 stage 3 with conv_post
    (32, dict(k_up=4, u=2, post_k=7), 256),   # v1 stage 3 with conv_post
    (24, dict(k_up=4, u=2), 256),
    (256, dict(k_up=16, u=8, pre=(80, 7)), 256),   # v1 stage 0, conv_pre folded
    (128, dict(k_up=16, u=8), 256),           # v1 stage 1
    (64, {}, 128),                            # K3 at each of v1's widths
    (256, {}, 256),
])
def test_each_width_keeps_its_tile(c, geom, tile):
    """The swizzled rows cost no shared memory, so each width keeps the tile
    of the unpadded layout; a row stride padded to L + 8 (what conflict-free
    fragment loads would need without the swizzle) halves the tile at C = 64
    and in the cluster layout (26 % more halo recompute at C = 64)."""
    assert _tile(c, **geom) == tile
    padded = _tile(c, stride=8, **geom)
    if c in (64, 128, 256):
        assert padded == tile // 2
    else:
        assert padded == tile


def _banks(addresses):
    return len({a % 32 for a in addresses})


@pytest.mark.parametrize('L', [192, 256, 384, 640, 1152])
def test_swizzle_makes_fragment_accesses_conflict_free(L):
    """swz permutes positions inside 32-float blocks; an A fragment's load
    (rows r0 + t and r0 + t + 4, positions q + g) and an accumulator tile's
    store (rows r0 + 2t + e, positions q + g) hit 32 banks at every offset
    q and row base r0 (a multiple of 8), as conv_layer reads and writes."""
    assert {_swz(r) for r in range(64)} == {0, 8, 16, 24}

    def at(row, col):
        return row * L + (col ^ _swz(row))
    for r0 in (0, 8, 16, 24):
        for q in range(40):
            lanes = [(g, t) for g in range(8) for t in range(4)]
            for h in (0, 4):
                assert _banks([at(r0 + t + h, q + g) for g, t in lanes]) == 32, (r0, q, h)
            for e in (0, 1):
                assert _banks([at(r0 + 2 * t + e, q + g) for g, t in lanes]) == 32, (r0, q, e)
    for row in range(16):
        assert sorted(at(row, c) - row * L for c in range(L)) == list(range(L))
    # conv_layer's per-lane swizzle of A rows t and t + 4
    src = SRC[SRC.index('__device__ void conv_layer('):]
    assert 'const int swa0 = t << 3;' in src and 'const int swa1 = (t ^ 1) << 3;' in src
    assert all(_swz(8 * k + t) == t << 3 and _swz(8 * k + t + 4) == (t ^ 1) << 3
               for k in range(4) for t in range(4))


@pytest.mark.parametrize('q_stride', [32, 34, 48, 286, 571, 1000])
def test_input_span_rows_are_conflict_free(q_stride):
    """The transposed conv's A fragments read input rows t and t + 4 of the
    span at 8 consecutive positions: q_row = 8 (mod 16) puts them on 32
    banks at any offset."""
    q_row = _q_row(q_stride)
    assert q_stride <= q_row < q_stride + 16 and q_row % 16 == 8
    for q in range(32):
        for h in (0, 4):
            assert _banks([(t + h) * q_row + q + g for g in range(8) for t in range(4)]) == 32


def _route(c):
    """(threads, n-tiles per warp) launch() gives a width, in every mode."""
    src = SRC[SRC.index('void (*kernel)(const Stage, const Plan) ='):]
    rules = re.findall(r'(wide|n_tiles % (\d) == 0) *\? gen_stage_kernel<(\w+), (\d), kMode>',
                       src)
    last = re.search(r': gen_stage_kernel<(\w+), (\d), kMode>;', src)
    n_tiles = c // 8
    for cond, mod, threads, ni in rules:
        if (cond == 'wide' and c > 64) or (mod and c <= 64 and n_tiles % int(mod) == 0):
            return CONST[threads], int(ni)
    return CONST[last.group(1)], int(last.group(2))


@pytest.mark.parametrize('c,route', [(8, (512, 1)), (16, (512, 2)), (24, (512, 1)),
                                     (32, (512, 4)), (48, (512, 2)), (64, (512, 4)),
                                     (128, (384, 4)), (256, (384, 4))])
def test_width_routes(c, route):
    """Each width's kernel: 512 threads and the largest of 4, 2, 1 n-tiles per
    warp that divides C / 8, or the cluster layout's 384 threads and its
    32-channel slice (4 n-tiles) per warp. In the cluster layout the widest
    conv range of a tile (the first conv of the k = 11 block, 110 samples of
    halo beyond the tile) fits one wave of m-tiles, so each peer chunk is
    staged once per conv, and one float4 per thread and kStageVec copies a
    peer chunk."""
    assert _route(c) == route
    threads, ni = route
    warps = threads // 32
    cs = c if c <= 64 else CONST['kSlice']
    groups = cs // (8 * ni)
    mi = CONST['kTiles'] // ni
    if c > 64:
        widest = CONST['kWideMaxTile'] + 110
        assert -(-widest // 16) <= (warps // groups) * mi
        expr = re.search(r'constexpr int kStageVec = (.*?);', SRC).group(1)
        stage_vec = eval(expr.replace('/', '//'), dict(CONST))
        L = CONST['kWideMaxTile'] + 2 * CONST['kHalo']
        assert stage_vec * threads * 4 == CONST['kKC'] * L


def _warp_slots(cs, ni, warps, m_tiles, pairs=False):
    """conv_layer's split of a conv's m-tiles: per wave and warp, the slots
    as (m-tile, first n-tile, n-tiles) of this block's slice. ``pairs``: an
    even split of (m-tile, 16-channel half) units instead, for the 32-channel
    slices (not the kernel's: it measured slower, PERF.md)."""
    if pairs:
        units, waves = 2 * m_tiles, []
        for base in range(0, units, 4 * warps):
            span = min(units - base, 4 * warps)
            waves.append([[(u // 2, 2 * (u % 2), 2)
                           for u in range(base + w * span // warps,
                                          base + (w + 1) * span // warps)]
                          for w in range(warps)])
        return waves
    mi = CONST['kTiles'] // ni
    groups = cs // (8 * ni)
    wm = warps // groups
    waves = []
    for first in range(0, m_tiles, wm * mi):
        wave = []
        for w in range(warps):
            ng, m0 = w // wm, first + w % wm
            cnt = max(0, min(mi, -(-(m_tiles - m0) // wm))) if ng < groups else 0
            wave.append([(m0 + wm * k, ng * ni, ni) for k in range(cnt)])
        waves.append(wave)
    return waves


def _lanes_of_conv(cs, ni, warps, lo, hi):
    """The (channel, position) outputs conv_layer's lanes write: accumulator
    rows g, g + 8 and columns 2t, 2t + 1 of each slot's tiles."""
    written = []
    for wave in _warp_slots(cs, ni, warps, -(-(hi - lo) // 16)):
        for slots in wave:
            assert len(slots) <= CONST['kTiles'] // ni
            for m, n0, nt in slots:
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for n in range(nt):
                        for e in range(4):
                            co = (n0 + n) * 8 + 2 * t + (e & 1)
                            p = lo + 16 * m + g + 8 * (e >> 1)
                            if p < hi:
                                written.append((co, p))
    return written


@pytest.mark.parametrize('cs,ni,warps,lo,hi', [
    (64, 4, 16, 9, 247),      # C = 64, the widest conv of a 128-sample tile
    (64, 4, 16, 64, 192),
    (32, 4, 12, 9, 375),      # a cluster slice, 256-sample tile
    (32, 4, 12, 64, 320),
    (32, 4, 16, 61, 323),     # C = 32, single block
    (16, 2, 16, 3, 637),
    (8, 1, 16, 9, 1143),
    (24, 1, 16, 64, 320),     # three channel groups, one warp idle
    (48, 2, 16, 40, 280),
])
def test_every_output_is_written_once(cs, ni, warps, lo, hi):
    """conv_layer's slots cover every (channel, position) of [lo, hi) exactly
    once (the same mapping places each output's sum in one lane, so no two
    lanes race and no output is left unwritten)."""
    src = SRC[SRC.index('__device__ void conv_layer('):]
    for line in ('const int wm = (blockDim.x >> 5) / n_groups;',
                 'const int m_first = wave * per_wave + wi;',
                 'ng < n_groups ? max(0, min(MI, (m_tiles - m_first + wm - 1) / wm)) : 0;',
                 'const int pos0 = lo + 16 * m_first + g;',
                 'const int co = (ng * NI + n) * 8 + 2 * t + (e & 1);',
                 'const int p = pos0 + 16 * wm * i + 8 * (e >> 1);'):
        assert line in src, line
    written = _lanes_of_conv(cs, ni, warps, lo, hi)
    assert len(written) == len(set(written)) == cs * (hi - lo)


def _ranges(tile, post=0):
    """Each ResBlock1 conv's output range width, as plan_tile walks them back
    from the block sum (kernels 3, 7, 11; dilations 1, 3, 5)."""
    widths = []
    for k in (3, 7, 11):
        r = tile + 2 * post
        convs = [(k, d) for dil in (1, 3, 5) for d in (dil, 1)]
        for kk, d in reversed(convs):
            widths.append((k, r))
            r += 2 * (kk - 1) // 2 * d
    return widths


@pytest.mark.parametrize('cs,warps,tile,saved', [(32, 12, 256, 0.11), (32, 16, 256, 0.23)])
def test_round_robin_waits_on_the_fullest_warps(cs, warps, tile, saved):
    """The tiles a conv waits on (the most any warp holds, times the taps),
    summed over a stage's 18 convs, in the cluster layout (12 warps) and at
    C = 32 (16 warps): the kernel's round robin of whole m-tiles leaves some
    warps with two and others with one, and an even split of (m-tile, half)
    units would wait on 11 % and 23 % fewer. (That split, built, measured
    slower: its bookkeeping tripled the spills; PERF.md.)"""
    def waited(pairs):
        total = 0
        for k, r in _ranges(tile):
            slots = _warp_slots(cs, 4, warps, -(-r // 16), pairs)
            total += k * sum(max(sum(nt for _, _, nt in w) for w in wave) for wave in slots)
        return total
    assert 1 - waited(True) / waited(False) == pytest.approx(saved, abs=0.005)


def test_fragments_are_the_kernel_b_operand():
    """tf32_fragments(w) read at conv_layer's index ((j S + s) S + n) 32 +
    lane gives lane (g, t) the hi / lo pairs of w[8n + g][8s + t][j] and
    w[8n + g][8s + t + 4][j]; hi + lo = w exactly, hi on the TF32 grid; the
    transposed conv reads its weight's transpose the same way."""
    assert 'wf + (static_cast<size_t>(j * S + c * (kKC / 8)) * S + n0) * 32 + lane' in SRC
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((24, 16, 3)).astype(np.float32))
    frag = gs.tf32_fragments(w).reshape(-1, 4)
    s_in, n_out = 2, 3
    for j in range(3):
        for s in range(s_in):
            for n in range(n_out):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    hi0, hi1, lo0, lo1 = frag[((j * s_in + s) * n_out + n) * 32 + lane]
                    w0, w1 = w[8 * n + g, 8 * s + t, j], w[8 * n + g, 8 * s + t + 4, j]
                    assert hi0 + lo0 == w0 and hi1 + lo1 == w1
                    assert int(hi0.view(torch.int32)) & 0x1fff == 0
    up = torch.from_numpy(rng.standard_normal((32, 16, 16)).astype(np.float32))
    assert torch.equal(gs.tf32_fragments(up.transpose(0, 1)),
                       gs.tf32_fragments(up.transpose(0, 1).contiguous()))


def test_split_kernel_index_is_tf32_fragments():
    """A numpy twin of tf32_split_kernel, read from the source: entry e of
    the launch, decomposed as the kernel decomposes it, writes the
    fragments of tf32_fragments bit for bit, for a stage's ConvTranspose1d
    weight (read through its transpose) and its resblock convs in one
    launch, each weight's fragments at twice its element offset, where the
    stage kernel's pointers find them."""
    for text in ('const long long src = jobs.transposed[j] ? (i * co + o) * k + tap : '
                 '(o * ci + i) * k + tap;',
                 'float* dst = out + 2 * jobs.start[j] + ((l >> 1) << 2) + h;',
                 '__uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u)',
                 'if (s.k_up > 0) add(up_w, s.c, 2 * s.c, s.k_up, 1);',
                 'add(static_cast<const float*>(conv_w[i]), s.c, s.c, conv_k[i], 0);',
                 'if (s.k_up > 0) s.up_w = reinterpret_cast<const float4*>(frags);',
                 'const long long at = jobs.start[first + i];',
                 ': reinterpret_cast<const float4*>(frags + 2 * at);'):
        assert text in SRC
    rng = np.random.default_rng(6)
    weights = [(rng.standard_normal((32, 16, 16)).astype(np.float32), True),
               (rng.standard_normal((16, 16, 3)).astype(np.float32), False),
               (rng.standard_normal((16, 16, 11)).astype(np.float32), False)]
    dims = [((w.shape[1], w.shape[0]) if tr else w.shape[:2]) + (w.shape[2],)
            for w, tr in weights]
    start = np.concatenate([[0], np.cumsum([co * ci * k for co, ci, k in dims])])
    out = np.full(2 * start[-1], np.nan, dtype=np.float32)
    for e in range(start[-1]):
        j = int(np.searchsorted(start, e, side='right')) - 1
        (w, tr), (co, ci, k), l = weights[j], dims[j], e - start[j]
        h, t, g, r = l & 1, (l >> 1) & 3, (l >> 3) & 7, l >> 6
        nt, r = r % (co // 8), r // (co // 8)
        ks, tap = r % (ci // 8), r // (ci // 8)
        o, i = 8 * nt + g, 8 * ks + 4 * h + t
        v = w.reshape(-1)[(i * co + o) * k + tap if tr else (o * ci + i) * k + tap]
        hi = ((v.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)
        dst = 2 * start[j] + ((l >> 1) << 2) + h
        out[dst], out[dst + 2] = hi, v - hi
    for (w, tr), a, b in zip(weights, start[:-1], start[1:]):
        ref = gs.tf32_fragments(torch.from_numpy(w).transpose(0, 1).contiguous() if tr
                                else torch.from_numpy(w))
        np.testing.assert_array_equal(out[2 * a:2 * b], ref.reshape(-1).numpy())


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _conv_emulated_bf16(x, w, b, d, precision, mode, slice_=32):
    """One resblock conv of x (C, P) in a bf16 mode as the kernel sums it:
    per output slice its own 16-channel chunks first, each chunk and tap one
    m16n8k16 k-step whose products ('bf16x3': lo hi, hi lo, hi hi of bf16
    splits; 'default': of bf16-rounded operands) go into a fresh
    accumulator, rounded toward zero, added to the fp32 total ('kernel'), or
    into one accumulator for all ('chain'); 'plain' is the plain version.
    The slices run as one batch."""
    c, p = x.shape
    k = w.shape[2]
    pad = (k - 1) // 2 * d
    if mode == 'plain':
        return gs._mode_conv(F.conv1d, x[None], w, b, precision, padding=pad, dilation=d)[0]
    xp = F.pad(x, (pad, pad))
    taps = [xp[:, j * d:j * d + p] for j in range(k)]
    if precision == 'bf16x3':
        wh = _bf16(w)
        pairs = [((_bf16(a - _bf16(a)), wh), (_bf16(a), _bf16(w - wh)), (_bf16(a), wh))
                 for a in taps]
    else:
        pairs = [((_bf16(a), _bf16(w)),) for a in taps]
    n_slices, n_chunks = c // slice_, c // 16
    total = torch.zeros((n_slices, slice_, p))
    acc = torch.zeros((n_slices, slice_, p))
    for i in range(n_chunks):
        chunk = [(i + s * slice_ // 16) % n_chunks for s in range(n_slices)]   # own first
        for j in range(k):
            part = acc if mode == 'chain' else torch.zeros_like(acc)
            for a, bw in pairs[j]:
                av = torch.stack([a[16 * q:16 * q + 16] for q in chunk]).double()
                bv = torch.stack([bw[s * slice_:(s + 1) * slice_, 16 * q:16 * q + 16, j]
                                  for s, q in enumerate(chunk)]).double()
                part = _round_to_zero(part.double() + torch.bmm(bv, av))
            if mode == 'chain':
                acc = part
            else:
                total = total + part
    return (acc if mode == 'chain' else total).reshape(c, p) + b[:, None]


@pytest.fixture
def one_thread():
    """torch on one thread: the emulations' small float64 batched products
    take 50x longer with every worker of a parallel test run on all cores
    (85 s against 1.5 s, four runs side by side on 8 cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize('precision,mode', [('bf16x3', 'kernel'), ('bf16x3', 'chain'),
                                            ('default', 'kernel'), ('default', 'chain')])
def test_bf16_modes_keep_the_stage_tolerance(precision, mode, one_thread):
    """A ResBlock1 stack at C = 256, k = 11, dilations 1 / 3 / 5 over 64
    positions, the kernel's bf16 sums against the plain version of the same
    mode, relative to its max abs. 'bf16x3': the kernel's runs (a k-step's
    three products in a fresh accumulator) measured 2.0e-6, within
    BF16X3_TOL / 2 (2^-17; the split itself keeps ~16 bits, so a 1-ulp
    fp32 difference moves a product by up to 2^-17), and one accumulator
    chain 1.9e-5, outside BF16X3_TOL. 'default': 9.0e-4 with the runs and
    9.7e-4 chained, both within DEFAULT_STAGE_TOL / 2: the differences are
    fp32-level ones that bf16 rounding turns into whole bf16 ulps (2^-8) in
    the next conv's operands, so the accumulator's rounding (~2^-23 a
    k-step) does not show, and the single-block layout chains its one
    product per k-step."""
    rng = np.random.default_rng(0)
    c, k = 256, 11
    convs = [(torch.from_numpy((rng.standard_normal((c, c, k)) / np.sqrt(c * k))
                               .astype(np.float32)),
              torch.from_numpy((rng.standard_normal(c) * 0.05).astype(np.float32)), dil)
             for d in (1, 3, 5) for dil in (d, 1)]
    x = torch.from_numpy(rng.standard_normal((c, 64)).astype(np.float32))
    plain = _resblock(x, convs, lambda v, w, b, d: _conv_emulated_bf16(v, w, b, d, precision,
                                                                       'plain'))
    got = _resblock(x, convs, lambda v, w, b, d: _conv_emulated_bf16(v, w, b, d, precision,
                                                                     mode))
    err = float((got - plain).abs().max() / plain.abs().max())
    if precision == 'bf16x3':
        assert (err <= BF16X3_TOL / 2) if mode == 'kernel' else (err > BF16X3_TOL), (mode, err)
    else:
        assert 2 ** -12 < err <= DEFAULT_STAGE_TOL / 2, (mode, err)


@pytest.mark.parametrize('L', [192, 256, 384, 640, 1152])
def test_swizzle_keeps_bf16_fragment_loads_conflict_free(L):
    """bf16_step loads channel rows t, t + 4, t + 8 and t + 12 of a 16-row
    chunk (a multiple of 16 rows in) at positions p + g and p + g + 8, one
    row per load instruction; the swizzle puts each load on 32 banks, as
    it does the TF32 k-steps' rows t and t + 4, and rows t + 8, t + 12
    take the swizzles of t, t + 4 (swa0, swa1)."""
    src = SRC[SRC.index('__device__ __forceinline__ void bf16_step('):]
    src = src[:src.index('\n}\n')]
    for line in ('const int r0 = cb + t * L;   // channel rows t, t + 4, t + 8, t + 12',
                 'const int r1 = r0 + 4 * L;', 'const int r2 = r0 + 8 * L;',
                 'const int r3 = r0 + 12 * L;',
                 'const int pa = p ^ swa0, pb = (p + 8) ^ swa0, pc = p ^ swa1, '
                 'pd = (p + 8) ^ swa1;',
                 'float a[8] = {sm[r0 + pa], sm[r1 + pc], sm[r0 + pb], sm[r1 + pd], '
                 '0.f, 0.f, 0.f, 0.f};',
                 'a[4] = sm[r2 + pa];', 'a[5] = sm[r3 + pc];', 'a[6] = sm[r2 + pb];',
                 'a[7] = sm[r3 + pd];'):
        assert line in src, line

    swz = [_swz(row) for row in range(64)]

    def at(row, col):
        return row * L + (col ^ swz[row])
    assert all(_swz(16 * k + t + 8 * r) == t << 3 and _swz(16 * k + t + 4 + 8 * r) == (t ^ 1) << 3
               for k in range(4) for t in range(4) for r in (0, 1))
    lanes = [(g, t) for g in range(8) for t in range(4)]
    for r0 in (0, 16, 32, 48):
        for q in range(40):
            for h in (0, 4, 8, 12):
                for e in (0, 8):
                    assert _banks([at(r0 + t + h, q + g + e) for g, t in lanes]) == 32, (r0, q, h)


@pytest.mark.parametrize('q_stride', [32, 34, 48, 286, 571, 1000])
def test_input_span_rows_are_conflict_free_for_bf16(q_stride):
    """The bf16 transposed conv reads input rows t, t + 4, t + 8 and t + 12
    of a k-step at 8 consecutive positions: at q_row = 8 (mod 16), 8 q_row
    and 12 q_row are multiples of 32 floats, so rows t + 8 and t + 12 fall on
    the banks of t and t + 4."""
    src = SRC[SRC.index('__device__ void conv_transpose('):]
    assert ('const float a[8] = {sm[c0 + k0],          sm[c0 + k0 + 4 * qr],  sm[c1 + k0],'
            in src)
    q_row = _q_row(q_stride)
    for q in range(32):
        for h in (0, 4, 8, 12):
            assert _banks([(t + h) * q_row + q + g for g in range(8) for t in range(4)]) == 32


def _mma_m16n8k16(a_regs, b_regs):
    """PTX mma.m16n8k16 .bf16 on one warp's registers: a_regs[lane] four
    pairs (lower k first), b_regs[lane] two; returns D (16, 8) = A B with A
    and B as the fragment layout places the lanes' values."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for reg, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                          (g + 8, 2 * t + 8))):
            A[row, col:col + 2] = a_regs[lane][reg]
        for reg in (0, 1):
            B[2 * t + 8 * reg:2 * t + 8 * reg + 2, g] = b_regs[lane][reg]
    return A @ B


def test_bf16_fragments_are_the_kernel_b_operand():
    """bf16_fragments(w) read at conv_layer's index ((j S16 + s) N + n) 32 +
    lane, with the A registers bf16_step loads (channels t, t + 4 of the
    chunk in register 0 / 1, t + 8, t + 12 in 2 / 3), computes the chunk's
    part of the conv in an m16n8k16 product: lane (g, t)'s k slots 2t + h
    and 2t + 8 + h both hold channel 16s + 8r + 4h + t of their operand.
    hi + lo = w to bf16x3's accuracy, hi = w rounded to bf16, 'default'
    holds hi alone, and channels past C_in (C_in = 40: a half chunk) are
    zero. The transposed conv reads its weight's transpose the same way."""
    src = SRC[SRC.index('__device__ void conv_layer('):]
    assert 'sm, wf, (static_cast<size_t>(j * S16 + c) * S + n0) * 32 + lane, cb, L,' in src
    rng = np.random.default_rng(5)
    c_out, c_in, k = 24, 40, 3
    w = torch.from_numpy(rng.standard_normal((c_out, c_in, k)).astype(np.float32))
    # act (channel, position); frag (lane entry, hi / lo, register, half)
    act = torch.from_numpy(rng.standard_normal((c_in, 16)).astype(np.float32))
    frag = gs.bf16_fragments(w).float().reshape(-1, 2, 2, 2).numpy()
    hi_only = gs.bf16_fragments(w, 'default').float().reshape(-1, 1, 2, 2).numpy()
    np.testing.assert_array_equal(hi_only[:, 0], frag[:, 0])
    s16, n_out = 3, 3
    a_pad = F.pad(act, (0, 0, 0, 48 - c_in)).numpy()
    for j in range(k):
        for s in range(s16):
            rows = a_pad[16 * s:16 * s + 16]
            a_regs = [[(rows[t + 8 * r, g + 8 * m], rows[t + 4 + 8 * r, g + 8 * m])
                       for r, m in ((0, 0), (0, 1), (1, 0), (1, 1))]
                      for g in range(8) for t in range(4)]
            for n in range(n_out):
                lanes = frag[((j * s16 + s) * n_out + n) * 32:((j * s16 + s) * n_out + n + 1) * 32]
                got = _mma_m16n8k16(a_regs, lanes[:, 0]) + _mma_m16n8k16(a_regs, lanes[:, 1])
                want = (w[8 * n:8 * n + 8, 16 * s:16 * s + 16, j].double().numpy()
                        @ act[16 * s:16 * s + 16].double().numpy()).T
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
                hi_part = _mma_m16n8k16(a_regs, lanes[:, 0])
                want_hi = (_bf16(w[8 * n:8 * n + 8, 16 * s:16 * s + 16, j]).double().numpy()
                           @ act[16 * s:16 * s + 16].double().numpy()).T
                np.testing.assert_allclose(hi_part, want_hi, rtol=1e-12, atol=1e-12)
    up = torch.from_numpy(rng.standard_normal((32, 16, 16)).astype(np.float32))
    assert torch.equal(gs.bf16_fragments(up.transpose(0, 1)),
                       gs.bf16_fragments(up.transpose(0, 1).contiguous()))


def test_bf16_split_kernel_index_is_bf16_fragments():
    """A numpy twin of bf16_split_kernel, read from the source: entry e of
    the launch, decomposed as the kernel decomposes it, writes the
    fragments of bf16_fragments bit for bit in both modes, for a stage's
    ConvTranspose1d weight (through its transpose) and resblock convs (C =
    24: a half chunk, zero-padded) in one launch, weight j at parts x its
    padded entry offset."""
    for text in ('const long long o = 8 * nt + g, i = 16 * ks + 8 * r + 4 * h + t;',
                 'const float v = i < ci ? __ldg(jobs.w[j] + src) : 0.f;',
                 '__nv_bfloat16* dst = out + parts * (jobs.start[j] + ((l >> 2) << 2)) + (l & 3);',
                 'if (parts == 2) dst[4] = __float2bfloat16_rn(v - __bfloat162float(hi));',
                 'const long long rows = bf16 ? (c_in + 15) / 16 * 16 : c_in;',
                 'const long long at = jobs.start[first + i];',
                 'reinterpret_cast<const __nv_bfloat16*>(frags) + parts * at)'):
        assert text in SRC, text
    rng = np.random.default_rng(6)
    weights = [(rng.standard_normal((48, 24, 4)).astype(np.float32), True),
               (rng.standard_normal((24, 24, 3)).astype(np.float32), False),
               (rng.standard_normal((24, 24, 11)).astype(np.float32), False)]
    dims = [((w.shape[1], w.shape[0]) if tr else w.shape[:2]) + (w.shape[2],)
            for w, tr in weights]
    start = np.concatenate([[0], np.cumsum([co * (-(-ci // 16) * 16) * k
                                            for co, ci, k in dims])])
    for precision, parts in (('bf16x3', 2), ('default', 1)):
        out = np.full(parts * start[-1], np.nan, dtype=np.float32)
        for e in range(start[-1]):
            j = int(np.searchsorted(start, e, side='right')) - 1
            (w, tr), (co, ci, k), l = weights[j], dims[j], e - start[j]
            h, r, t, g, q = l & 1, (l >> 1) & 1, (l >> 2) & 3, (l >> 4) & 7, l >> 7
            nt, q = q % (co // 8), q // (co // 8)
            s16 = -(-ci // 16)
            ks, tap = q % s16, q // s16
            o, i = 8 * nt + g, 16 * ks + 8 * r + 4 * h + t
            v = (w.reshape(-1)[(i * co + o) * k + tap if tr else (o * ci + i) * k + tap]
                 if i < ci else np.float32(0))
            hi = torch.tensor(v).to(torch.bfloat16).float().numpy()
            dst = parts * (start[j] + ((l >> 2) << 2)) + (l & 3)
            out[dst] = hi
            if parts == 2:
                out[dst + 4] = torch.tensor(v - hi).to(torch.bfloat16).float().numpy()
        for (w, tr), a, b in zip(weights, start[:-1], start[1:]):
            ref = gs.bf16_fragments(torch.from_numpy(w).transpose(0, 1).contiguous() if tr
                                    else torch.from_numpy(w), precision)
            np.testing.assert_array_equal(out[parts * a:parts * b], ref.float().reshape(-1).numpy())
