"""What the flash-attention forward kernel (K5a / K5b's forward,
``csrc/flash_attention.cu::flash_fwd_kernel``) rests on, checked on the CPU:

- that skipping key tiles whose keys are all masked is exact: a tile loop in
  fp32 that mirrors the kernel's online softmax gives o and lse bit for bit
  the same with and without the skip (leading, interior and trailing masked
  tiles, an item with every key masked), and agrees with JAX's Pallas
  forward in interpret mode (tests/test_torch_attention.py's sizes and
  tolerance);
- that its arithmetic keeps the forward tolerance: an emulation of the
  kernel's 3xTF32 products (the split_tf32 operands, each mma rounded
  toward zero into its accumulator, a fresh accumulator per 8-deep step of
  s and per key tile of P V) against fp64, beside one TF32 pass;
- that ``forward_key_tile`` follows the kernel source's tile rule.

The kernel itself runs on a card (tests/test_torch_cuda.py, chip_smoke.py
phase 10).
"""

import math
import os
import re

import jax

jax.config.update('jax_platforms', 'cpu')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.ops.pallas import flash_attention as jfa  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from test_torch_flash_backward import _kernel_products, _tf32, _valid  # noqa: E402

FLASH_FWD_TOL = 1e-5    # chip_smoke.py / tests/test_torch_cuda.py: max abs error / max abs
CU = os.path.join(os.path.dirname(__file__), '..', fa.SOURCE)


def _tile_loop(q, k, v, kv, tile, skip, scores=None, tile_pv=None):
    """(o, lse) by the kernel's online softmax over ``tile``-key tiles, in
    fp32: m starts at -1e30, masked keys score -1e30; per tile m_new =
    max(m, row max), alpha = exp(m - m_new), l = l alpha + rowsum(p),
    o = o alpha + p v. ``skip`` leaves out the tiles ``live_key_tiles``
    drops. ``scores(q, k)`` and ``tile_pv(p, v)`` give the products (exact
    fp32 matmuls by default)."""
    scores = scores or (lambda a, b: torch.matmul(a, b.transpose(-1, -2)))
    tile_pv = tile_pv or torch.matmul
    n, h, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    m = torch.full((n, h, tq), -1e30)
    l = torch.zeros((n, h, tq))
    o = torch.zeros((n, h, tq, d))
    live = fa.live_key_tiles(kv, tile)
    for j in range(-(-tk // tile)):
        cols = slice(j * tile, min((j + 1) * tile, tk))
        s = scores(q, k[:, :, cols]) * scale
        s = torch.where(kv[:, None, None, cols] > 0.5, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + p.sum(dim=-1)
        o_new = o * alpha[..., None] + tile_pv(p, v[:, :, cols])
        take = live[:, j][:, None, None] if skip else torch.ones((n, 1, 1), dtype=torch.bool)
        m, l = torch.where(take, m_new, m), torch.where(take, l_new, l)
        o = torch.where(take[..., None], o_new, o)
    denom = l.clamp_min(1e-30)
    return o / denom[..., None], m + torch.log(denom)


# per item, the (start, end) spans of valid keys over 200 keys: leading and
# trailing masked tiles, an interior one, every key masked, every key valid
SPANS = [((70, 100),), ((0, 10), (150, 200)), (), ((0, 200),)]


@pytest.mark.parametrize('tile', [fa.forward_key_tile(16), 16])
def test_skipping_masked_tiles_is_exact(tile):
    """The tile loop with and without the skip: o and lse bit-identical; the
    all-masked item is the mean of v (no tile of it is skipped); the items
    with a valid key agree with JAX's Pallas forward (o) and its residual
    (lse) in interpret mode, atol 1e-5."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((4, 2, 200, 16)).astype(np.float32) for _ in range(3))
    kv = _valid(SPANS, 200)
    tq, tk, tv, tkv = (torch.from_numpy(a) for a in (q, k, v, kv))
    live = fa.live_key_tiles(tkv, tile)
    assert not bool(live[0, 0]) and not bool(live[0, -1]) and bool(live[2].all())
    if tile == 16:
        assert not bool(live[1, 5])                  # an interior masked tile

    o, lse = _tile_loop(tq, tk, tv, tkv, tile, skip=True)
    o_all, lse_all = _tile_loop(tq, tk, tv, tkv, tile, skip=False)
    assert torch.equal(o, o_all) and torch.equal(lse, lse_all)
    torch.testing.assert_close(o[2], tv[2].mean(dim=1, keepdim=True).expand_as(o[2]),
                               rtol=0, atol=1e-6)

    keep = [0, 1, 3]
    ref = np.asarray(jfa.flash_attention(q[keep], k[keep], v[keep], mask=kv[keep] < 0.5,
                                         block_q=32, block_kv=32))
    np.testing.assert_allclose(o[keep].numpy(), ref, atol=1e-5)
    out, res = jfa._flash_fwd_impl(q[keep], k[keep], v[keep], kv[keep], 32, 32, True)
    lse_ref = np.asarray(res[-1])[:, :200, 0].reshape(3, 2, 200)
    np.testing.assert_allclose(o[keep].numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(lse[keep].numpy(), lse_ref, atol=1e-5)


def test_3xtf32_keeps_the_forward_tolerance():
    """At D = 64 (MultiHeadAttention(512, 8)'s head width) with a key mask
    (an item with leading masked tiles, a suffix mask), the kernel's
    arithmetic emulated (3xTF32 products of split_tf32 operands rounded
    toward zero per mma, a fresh accumulator per 8-deep step of s and per
    64-key tile of P V, the online softmax in fp32) gives o and lse within
    FLASH_FWD_TOL / 2 of the fp64 forward: measured 8.3e-7 (o) and 8.9e-8
    (lse) of the max abs. One TF32 pass of the same products is outside
    FLASH_FWD_TOL (o 4.8e-4, lse 3.7e-5), so the tolerance tells the two
    apart."""
    g = torch.Generator().manual_seed(31)
    q, k, v = (torch.randn((2, 2, 192, 64), generator=g) for _ in range(3))
    kv = torch.from_numpy(_valid([((70, 192),), ((0, 150),)], 192))
    tile = fa.forward_key_tile(64)
    o64, lse64 = fa.attention_reference(q.double(), k.double(), v.double(), kv.double())

    def tf32_mm(a, b):
        return torch.matmul(_tf32(a.contiguous()), _tf32(b.contiguous()))

    emulated = {
        '3xtf32': dict(scores=lambda a, b: _kernel_products(a, b, True),
                       tile_pv=lambda p, x: _kernel_products(
                           p, x.transpose(-1, -2).contiguous(), False)),
        'tf32': dict(scores=lambda a, b: tf32_mm(a, b.transpose(-1, -2)), tile_pv=tf32_mm),
    }
    errs = {}
    for mode, products in emulated.items():
        o, lse = _tile_loop(q, k, v, kv, tile, skip=True, **products)
        errs[mode] = [float((got.double() - ref).abs().max() / ref.abs().max())
                      for got, ref in ((o, o64), (lse, lse64))]
    assert max(errs['3xtf32']) <= FLASH_FWD_TOL / 2, errs
    assert min(errs['tf32']) > FLASH_FWD_TOL, errs


def test_forward_key_tile_follows_the_kernel_source():
    """``forward_key_tile`` against the forward kernel's tiles in
    ``csrc/flash_attention.cu``: ``BwdTile<DP, dq_split(DP), kFwdWarps>``,
    whose BN rule it reads."""
    src = open(CU).read()
    kernel = src[src.index('flash_fwd_kernel('):]
    assert 'using T = BwdTile<DP, dq_split(DP), kFwdWarps>;' in kernel[:1500]
    expr = re.search(r'static constexpr int BN = (.*?);', src).group(1)
    cond, wide, narrow = re.match(r'(.*?) \? (\d+) : (\d+)$', expr).groups()
    for d in (1, 16, 17, 32, 64, 65, 128, 160, 192, 256):
        dp = next(p for p in (16, 32, 64, 128, 192, 256) if d <= p)
        assert fa.forward_key_tile(d) == int(wide if eval(cond, {'DP': dp}) else narrow), d
