"""What the flash-attention backward kernels (K5b, ``csrc/flash_attention.cu``)
rest on, checked on the CPU:

- which key tiles they skip: ``live_key_tiles`` against a numpy reckoning
  from the mask, and ``backward_key_tiles`` against the kernel source's
  tile rule;
- that skipping is exact: on the plain versions, the masked keys of an item
  with a valid key get dK = dV = 0 exactly and change dQ by nothing, and the
  gradients under such masks agree with JAX's Pallas backward kernels in
  interpret mode (tests/test_torch_attention.py's sizes);
- that 3xTF32 products are what keeps the unchanged tolerance: an emulation
  of the tensor cores' TF32 operands (round to nearest, 10 mantissa bits,
  through an int32 view) on the dK / dV / dQ formulas, 3xTF32 within
  FLASH_GRAD_TOL / 10 of the fp64 result and one TF32 pass outside
  FLASH_GRAD_TOL;
- that s and dp need a fresh accumulator per 8-deep step: with the kernel's
  operand split and the tensor cores' accumulator rounding toward zero
  emulated, an item with one valid key (where ds = p (dp - di) is rounding
  noise) stays at the fp32 plain version's own noise, where one accumulator
  chain through the head width is several times further off.

The kernels themselves run on a card (tests/test_torch_cuda.py,
chip_smoke.py phase 10).
"""

import math
import os
import re

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.ops.pallas import flash_attention as jfa  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

FLASH_GRAD_TOL = 1e-4   # chip_smoke.py / tests/test_torch_cuda.py: max abs error / max abs
CU = os.path.join(os.path.dirname(__file__), '..', fa.SOURCE)


def _valid(spans, t):
    """(N, t) float32 validity, 1 inside each item's (start, end) spans."""
    kv = np.zeros((len(spans), t), dtype=np.float32)
    for i, pairs in enumerate(spans):
        for a, b in pairs:
            kv[i, a:b] = 1.0
    return kv


def _live_np(kv, tile):
    """The skip rule reckoned per tile: a tile is processed if it holds a valid
    key or its item holds none."""
    n, t = kv.shape
    tiles = -(-t // tile)
    live = np.zeros((n, tiles), dtype=bool)
    for i in range(n):
        has_valid = bool((kv[i] >= 0.5).any())
        for j in range(tiles):
            live[i, j] = bool((kv[i, j * tile:(j + 1) * tile] >= 0.5).any()) or not has_valid
    return live


@pytest.mark.parametrize('t', [64, 100, 257])
@pytest.mark.parametrize('tile', [16, 32, 64])
def test_live_key_tiles_match_numpy(t, tile):
    """Suffix masks, whole masked tiles inside an item, an item with every key
    masked, a scattered mask and a ragged last tile."""
    rng = np.random.default_rng(t * tile)
    spans = [((0, t),), ((0, t // 3),), ((0, 5), (t - 7, t)), (), ((t // 2, t // 2 + 1),)]
    kv = np.concatenate([_valid(spans, t),
                         (rng.random((2, t)) < 0.05).astype(np.float32)])
    got = fa.live_key_tiles(torch.from_numpy(kv), tile)
    np.testing.assert_array_equal(got.numpy(), _live_np(kv, tile))
    assert bool(got[3].all())                        # the fully masked item
    if t > 2 * tile:
        assert not bool(got[2, 1])                    # a masked tile between valid keys


def test_backward_key_tiles_follow_the_kernel_source():
    """The Python reckoning of the kernels' key tiles (dK / dV: the 64 / SPLIT
    keys a block owns; dQ: the BN keys of a step) against the rule in
    ``csrc/flash_attention.cu``."""
    src = open(CU).read()

    def rule(pattern):
        expr = re.search(pattern, src).group(1)
        parts = re.split(r'\s*[?:]\s*', expr)      # c1 ? v1 : c2 ? v2 : v3

        def value(dp):
            for cond, val in zip(parts[0:-1:2], parts[1::2]):
                if eval(cond, {'dp': dp, 'DP': dp}):
                    return int(val)
            return int(parts[-1])
        return value

    dkv_split = rule(r'constexpr int dkv_split\(int dp\) \{ return (.*?); \}')
    bn = rule(r'static constexpr int BN = (.*?);')
    assert 'ROWS = 16 * WARPS / SPLIT' in src and 'int WARPS = kBwdWarps' in src
    assert 'kBwdWarps = 4' in src
    for d in (1, 16, 17, 32, 64, 65, 128, 160, 192, 256):
        dp = next(p for p in (16, 32, 64, 128, 192, 256) if d <= p)
        assert fa.backward_key_tiles(d) == (64 // dkv_split(dp), bn(dp)), d


def _residuals(q, k, v, kv, dout_fn):
    o, lse = fa.attention_forward(q, k, v, kv)
    dout = dout_fn(o)
    return dout, lse, (o * dout).sum(dim=-1)


def test_masked_keys_leave_the_gradients_exactly():
    """An item with a valid key: its masked keys' dK / dV are exactly 0 and
    leaving their columns out changes dQ by at most 1e-6 of its max abs, so
    a skipped tile changes no result; the gradients under these masks (a
    masked run inside item 0, a suffix on item 1) agree with JAX's Pallas
    backward kernels in interpret mode."""
    rng = np.random.default_rng(17)
    q, k, v = (rng.standard_normal((2, 2, 77, 16)).astype(np.float32) for _ in range(3))
    kv = _valid([((0, 20), (51, 77)), ((0, 60),)], 77)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jfa.flash_attention_trainable(q, k, v, kv, 32, 32)))

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tkv = (torch.from_numpy(a) for a in (q, k, v, kv))
    dout, lse, di = _residuals(tq, tk, tv, tkv, torch.cos)
    dk, dv = fa.attention_dkv(tq, tk, tv, tkv, dout, lse, di)
    dq = fa.attention_dq(tq, tk, tv, tkv, dout, lse, di)
    for got, want in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    masked = torch.from_numpy(kv < 0.5)
    for got in (dk, dv):
        assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())
    for i in range(2):
        keep = torch.from_numpy(kv[i] > 0.5)
        dq_kept = fa.attention_dq_reference(
            tq[i:i + 1], tk[i:i + 1, :, keep], tv[i:i + 1, :, keep], None,
            dout[i:i + 1], lse[i:i + 1], di[i:i + 1])
        err = float((dq_kept - dq[i:i + 1]).abs().max() / dq[i:i + 1].abs().max())
        assert err <= 1e-6, (i, err)


def _tf32(x):
    """x rounded to nearest (ties away from zero) to TF32's 10 mantissa bits."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _matmul(mode):
    """a @ b in fp32 with the operands as the tensor cores take them."""
    def tf32(a, b):
        return torch.matmul(_tf32(a), _tf32(b))

    def tf32x3(a, b):
        ah, bh = _tf32(a), _tf32(b)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)
    return {'tf32': tf32, '3xtf32': tf32x3, 'fp64': torch.matmul}[mode]


def _backward(q, k, v, kv, dout, mm):
    """dk, dv, dq by the kernels' formulas, every product through ``mm``;
    lse and di from the same products."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale
    s = torch.where(kv[:, None, None, :] > 0.5, s, torch.full_like(s, -1e30))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    o = mm(p, v)
    di = (o * dout).sum(dim=-1, keepdim=True)
    ds = p * (mm(dout, v.transpose(-1, -2)) - di) * scale
    return (mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), dout), mm(ds, k))


def test_3xtf32_keeps_the_gradient_tolerance():
    """At D = 64 (MultiHeadAttention(512, 8)'s head width) with a key mask,
    3xTF32 products give dK / dV / dQ within FLASH_GRAD_TOL / 10 of fp64;
    one TF32 pass does not stay within FLASH_GRAD_TOL, so the tolerance
    tells the two apart."""
    rng = np.random.default_rng(29)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((2, 2, 96, 64)).astype(np.float32))
                     for _ in range(4))
    kv = torch.from_numpy(_valid([((0, 96),), ((0, 40), (70, 96))], 96))
    ref = _backward(*(t.double() for t in (q, k, v, kv, dout)), _matmul('fp64'))
    errs = {}
    for mode in ('3xtf32', 'tf32'):
        got = _backward(q, k, v, kv, dout, _matmul(mode))
        errs[mode] = [float((g.double() - r).abs().max() / r.abs().max())
                      for g, r in zip(got, ref)]
    assert max(errs['3xtf32']) <= FLASH_GRAD_TOL / 10, errs
    assert min(errs['tf32']) > FLASH_GRAD_TOL, errs


def _trunc(x):
    """What the tensor cores read of a TF32 operand: the top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _kernel_products(a, b, fresh):
    """a b^T over the last axis as the kernels compute s and dp: operands
    split as split_tf32 does (hi = x + half a TF32 ulp, lo = x - hi, both
    read through the TF32 mask), three m16n8k8 products per 8-deep step,
    each rounded toward zero into its accumulator; ``fresh``: one accumulator
    per step, added in fp32 (mma_3xtf32_rn), else one accumulator for all."""
    def split(x):
        hi = _trunc((x.view(torch.int32) + 0x1000).view(torch.float32))
        return hi, _trunc(x - hi)

    def round_to_zero(d):
        f = d.float()
        return torch.where(f.double().abs() > d.abs(), torch.nextafter(f, torch.zeros_like(f)), f)

    (ah, al), (bh, bl) = split(a), split(b)
    out = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for c in range(0, a.shape[-1], 8):
        acc = torch.zeros_like(out) if fresh else out
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = round_to_zero(acc.double() + torch.matmul(
                x[..., c:c + 8].double(), y[..., c:c + 8].double().transpose(-1, -2)))
        out = out + acc if fresh else acc
    return out


def test_fresh_accumulator_per_step_holds_the_cancelling_item():
    """Item 1 has one valid key: p = 1 there and dp = di exactly, so its dK is
    the rounding noise of dp - di against the plain version's own. With
    exact products the gap to the fp32 plain version is that version's
    noise; the kernels' per-step accumulators stay within 2x of it, one
    chain of round-toward-zero accumulations is 3x further off still."""
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn((2, 2, 1024, 64), generator=g) for _ in range(4))
    kv = (torch.arange(1024)[None] < torch.tensor([[1024], [1]])).float()
    o, lse = fa.attention_reference(q, k, v, kv)
    di = (o * dout).sum(dim=-1)
    ref = fa.attention_dkv_reference(q, k, v, kv, dout, lse, di)[0]

    def dk_with(mm):
        s = torch.where(kv[:, None, None, :] > 0.5, mm(q, k) * 0.125, torch.tensor(-1e30))
        ds = torch.exp(s - lse[..., None]) * (mm(dout, v) - di[..., None]) * 0.125
        return torch.matmul(ds.transpose(-1, -2), q)

    err = {}
    for name, mm in (('exact', lambda a, b: torch.matmul(
            a.double(), b.double().transpose(-1, -2)).float()),
            ('step', lambda a, b: _kernel_products(a, b, True)),
            ('chain', lambda a, b: _kernel_products(a, b, False))):
        err[name] = float((dk_with(mm) - ref).abs().max() / ref.abs().max())
    assert err['step'] <= 2 * err['exact'] and err['step'] <= FLASH_GRAD_TOL / 2, err
    assert err['chain'] >= 3 * err['step'], err
