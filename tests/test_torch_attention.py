"""The port's flash attention (K5a / K5b) and blockwise attention against the
JAX package: its Pallas flash kernels in interpret mode and its ``lax`` scan.

The CUDA kernels run only on a card (``chip_smoke.py`` phase 10 and
``tests/test_torch_cuda.py`` hold them against the plain versions there);
here the wrappers' CPU dispatch (the plain versions) is held to the reference
at the JAX suite's tolerances (tests/test_attention.py): 1e-5 on outputs and
on the masked gradients, 1e-4 at D = 160 and on the block-geometry
gradients. Inputs come from numpy seeds and go to both packages. The port's
kernels pick their own tiles, so JAX's tile geometries go to the JAX side
only.
"""

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.ops import attention as jattn  # noqa: E402
from pytorch_sound_tpu.ops.pallas import flash_attention as jfa  # noqa: E402
from pytorch_sound_tpu_torch.ops import attention as attn  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402


def _qkv(rng, n=2, h=4, t=100, d=16):
    return tuple(rng.standard_normal((n, h, t, d)).astype(np.float32) for _ in range(3))


def _mask(n, t, start):
    mask = np.zeros((n, t), dtype=bool)
    mask[:, start:] = True
    return mask


def _t(*arrays, grad=False):
    return tuple(torch.from_numpy(a).requires_grad_(grad) for a in arrays)


@pytest.mark.parametrize('masked', [False, True])
def test_flash_attention_matches_pallas(masked):
    """K5a: tests/test_attention.py::test_flash_kernel_matches_dense."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, t=100, d=16)
    mask = _mask(2, 100, 70) if masked else None
    ref = np.asarray(jfa.flash_attention(q, k, v, mask=mask, block_q=32, block_kv=32))
    out = fa.flash_attention(*_t(q, k, v), mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_flash_trainable_grads_match_pallas():
    """K5b's gradients under a ragged key mask, against JAX's Pallas backward
    kernels (tests/test_attention.py::test_flash_backward_matches_dense_grads):
    autograd through the plain forward, and the kernels' plain backward from
    the residuals (attention_dq / attention_dkv on CPU tensors)."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, n=2, h=2, t=77, d=16)
    key_valid = (~_mask(2, 77, 60)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jfa.flash_attention_trainable(q, k, v, key_valid, 32, 32)))

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    kv = torch.from_numpy(key_valid)
    out = fa.flash_attention_trainable(tq, tk, tv, kv)
    torch.sin(out).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    q_, k_, v_ = _t(q, k, v)
    o, lse = fa.attention_forward(q_, k_, v_, kv)
    dout = torch.cos(o)
    di = (o * dout).sum(dim=-1)
    dk, dv = fa.attention_dkv(q_, k_, v_, kv, dout, lse, di)
    dq = fa.attention_dq(q_, k_, v_, kv, dout, lse, di)
    for got, want in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_flash_lse_matches_pallas_residual():
    """The forward's logsumexp is JAX's ``_fwd_res_kernel`` residual."""
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, n=2, h=2, t=77, d=16)
    key_valid = (~_mask(2, 77, 60)).astype(np.float32)
    out, res = jfa._flash_fwd_impl(q, k, v, key_valid, 32, 32, True)
    lse_ref = np.asarray(res[-1])[:, :77, 0].reshape(2, 2, 77)
    o, lse = fa.attention_forward(*_t(q, k, v), torch.from_numpy(key_valid))
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5)


def test_flash_wide_head_dim_matches_pallas():
    """D = 160 (tests/test_attention.py::test_flash_kernel_wide_head_dim)."""
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, n=1, h=2, t=96, d=160)
    ref = np.asarray(jfa.flash_attention(q, k, v, block_q=32, block_kv=32))
    np.testing.assert_allclose(fa.flash_attention(*_t(q, k, v)).numpy(), ref, atol=1e-4)
    g_ref = jax.grad(lambda q: jnp.sum(
        jfa.flash_attention_trainable(q, k, v, None, 32, 32) ** 2))(q)
    tq, tk, tv = _t(q, k, v, grad=True)
    (fa.flash_attention_trainable(tq, tk, tv) ** 2).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(g_ref), atol=1e-4)


@pytest.mark.parametrize('bq,bkv', [(32, 128), (256, 64), (64, 256)])
def test_flash_matches_pallas_block_geometries(bq, bkv):
    """The port (its kernels pick their own tiles) against JAX's Pallas
    kernels at each of its tile geometries (tests/test_attention.py::
    test_flash_asymmetric_blocks), output and dQ."""
    rng = np.random.default_rng(23)
    q, k, v = _qkv(rng, t=150, d=16)
    ref = np.asarray(jfa.flash_attention_trainable(q, k, v, None, bq, bkv, True, 'highest'))
    g_ref = jax.grad(lambda q: jnp.sum(jnp.sin(jfa.flash_attention_trainable(
        q, k, v, None, bq, bkv, True, 'highest'))))(q)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = fa.flash_attention_trainable(tq, tk, tv)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(g_ref), atol=1e-4)


@pytest.mark.parametrize('backend,block_size', [
    ('cuda', 256), ('scan', 7), ('scan', 16), ('scan', 64)])
def test_fully_masked_item_is_the_mean_of_v(backend, block_size):
    """The port's definition for an item with every key masked, on every
    backend and whether or not the scan pads its last key block (t = 30):
    the mean of v over the Tk keys, as the kernels and the dense plain
    version give it. The other item, half masked, stays the dense result."""
    q, k, v = _t(*_qkv(np.random.default_rng(3), n=2, h=2, t=30))
    mask = torch.zeros((2, 30), dtype=torch.bool)
    mask[0] = True
    mask[1, 15:] = True
    out = attn.blockwise_attention(q, k, v, mask=mask, block_size=block_size,
                                   backend=backend)
    torch.testing.assert_close(out[0], v[0].mean(dim=1, keepdim=True).expand_as(out[0]),
                               rtol=0, atol=1e-6)
    ref = fa.attention_reference(q, k, v, (~mask).float())[0]
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v = _t(*_qkv(np.random.default_rng(0), n=1, h=1, t=8, d=8))
    wide = torch.zeros((1, 1, 8, 300))
    with pytest.raises(ValueError, match='D <= 256'):
        fa._check('attention_forward', wide, wide, wide, None)
    with pytest.raises(ValueError, match='key_valid'):
        fa._check('attention_forward', q, k, v, torch.ones((1, 9)))
    with pytest.raises(ValueError, match='contiguous float32'):
        fa._check('attention_forward', q.double(), k, v, None)
    with pytest.raises(RuntimeError, match='cpu or cuda'):
        fa.attention_forward(*(t.to('meta') for t in (q, k, v)))


@pytest.mark.parametrize('backend', ['scan', 'auto', 'cuda'])
@pytest.mark.parametrize('masked', [False, True])
def test_blockwise_attention_matches_lax(backend, masked):
    """blockwise_attention on each backend against JAX's 'lax' scan, with a
    ragged length and a mask (tests/test_attention.py:29-43); 'cuda' on a
    CPU tensor is the kernels' plain version."""
    rng = np.random.default_rng(1 if masked else 0)
    t = 77 if masked else 100
    q, k, v = _qkv(rng, t=t)
    mask = _mask(2, t, 60) if masked else None
    ref = np.asarray(jattn.blockwise_attention(q, k, v, mask=mask, block_size=32,
                                               backend='lax'))
    out = attn.blockwise_attention(*_t(q, k, v),
                                   mask=None if mask is None else torch.from_numpy(mask),
                                   block_size=32, backend=backend)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize('backend', ['scan', 'cuda'])
def test_blockwise_attention_grads_match_lax(backend):
    """Gradients through each backend against jax.grad of the 'lax' scan
    (tests/test_attention.py::test_blockwise_pallas_backend_is_differentiable)."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, t=64)
    mask = _mask(2, 64, 50)
    ref = jax.grad(lambda q, k, v: jnp.sum(jattn.blockwise_attention(
        q, k, v, mask=mask, block_size=32, backend='lax', precision='highest') ** 2),
        argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = attn.blockwise_attention(tq, tk, tv, mask=torch.from_numpy(mask), block_size=32,
                                   backend=backend)
    (out ** 2).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_blockwise_attention_refuses_unknown_backend():
    q, k, v = _t(*_qkv(np.random.default_rng(0), t=8))
    with pytest.raises(ValueError, match='backend'):
        attn.blockwise_attention(q, k, v, backend='pallas')


def test_partials_and_combine_match_jax():
    """(acc, m, denom) partials and their combine against the JAX package's
    (tests/test_attention.py:58-77, :165-184)."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, n=2, h=2, t=160, d=16)
    ref = jattn.blockwise_attention_partials(q, k, v, block_size=64)
    got = attn.blockwise_attention_partials(*_t(q, k, v), block_size=64)
    for a, b in zip(got, ref):   # the denominators reach ~20: relative too
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)

    def shards(mod, arrs):
        qq, kk, vv = arrs
        return mod.combine_attention_partials(
            mod.blockwise_attention_partials(qq, kk[:, :, :96], vv[:, :, :96], block_size=32),
            mod.blockwise_attention_partials(qq, kk[:, :, 96:], vv[:, :, 96:], block_size=32))

    ref2, got2 = shards(jattn, (q, k, v)), shards(attn, _t(q, k, v))
    for a, b in zip(got2, ref2):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    acc, _, denom = got2
    dense = fa.attention_reference(*_t(q, k, v))[0]
    np.testing.assert_allclose((acc / denom).numpy(), dense.numpy(), atol=1e-5)
