"""The port's NN building blocks (MultiHeadAttention on both routes,
PointwiseFeedForward, PositionalEncoding) against the JAX package's flax
modules, with the flax weights carried over by ``load_jax_params``.

Outputs at the JAX suite's 2e-5 (tests/test_modules.py:48), input and
parameter gradients against ``jax.grad`` at 1e-4. On the CPU the blockwise
route runs the plain scan, as JAX's runs ``lax``.
"""

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.models import modules as jmod  # noqa: E402
from pytorch_sound_tpu_torch.models import modules as mod  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-4


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask(n, t, start):
    mask = np.zeros((n, t), dtype=bool)
    mask[:, start:] = True
    return mask


def _mha_pair(x, **kw):
    """A flax MHA with its initialised parameters and the port's MHA
    carrying them."""
    jm = jmod.MultiHeadAttention(hidden_dim=x.shape[1], heads=4, **kw)
    params = jm.init(jax.random.PRNGKey(0), x)
    tm = mod.load_jax_params(mod.MultiHeadAttention(x.shape[1], 4, **kw),
                             jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm.eval()


@pytest.mark.parametrize('masked', [False, True])
def test_mha_dense_route_matches_flax(masked):
    """Output and the (N, H, Tk, Tq) map, softmax over keys, masked keys and
    queries zero (tests/test_modules.py:15-31)."""
    x = _x(0, (2, 32, 10))
    mask = _mask(2, 10, 7) if masked else None
    jm, params, tm = _mha_pair(x)
    out_j, att_j = jm.apply(params, x, mask)
    with torch.no_grad():
        out_t, att_t = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert att_t.shape == (2, 4, 10, 10)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=TOL)
    np.testing.assert_allclose(att_t.numpy(), np.asarray(att_j), atol=TOL)
    if masked:
        assert float(att_t[:, :, 7:, :].abs().max()) == 0.0    # masked keys
        assert float(att_t[:, :, :, 7:].abs().max()) == 0.0    # masked queries


@pytest.mark.parametrize('kw,t,masked', [
    ({'block_size': 16}, 50, False),          # tests/test_attention.py:46-55
    ({'auto_threshold': 64}, 64, True),       # tests/test_modules.py:34-54
])
def test_mha_blockwise_route_matches_flax(kw, t, masked):
    x = _x(2, (2, 32, t))
    mask = _mask(2, t, 50) if masked else None
    jm, params, tm = _mha_pair(x, **kw)
    out_j, att_j = jm.apply(params, x, mask)
    with torch.no_grad():
        out_t, att_t = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert att_j is None and att_t is None
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=TOL, atol=TOL)
    if masked:
        _, att_s = tm(torch.from_numpy(x[:, :, :32]), torch.from_numpy(mask[:, :32]))
        assert att_s is not None and att_s.shape == (2, 4, 32, 32)   # below the threshold


@pytest.mark.parametrize('block_size', [-1, 16])
def test_mha_gradients_match_jax(block_size):
    """Input and parameter gradients of sum(sin(out) * w), masked, on the
    dense and the blockwise route, against jax.grad of the flax module."""
    x = _x(3, (2, 32, 40))
    mask = _mask(2, 40, 29)
    w = _x(4, (2, 32, 40))
    jm, params, tm = _mha_pair(x, block_size=block_size)

    def loss(p, x):
        return jnp.sum(jnp.sin(jm.apply(p, x, mask)[0]) * w)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.sin(tm(xt, torch.from_numpy(mask))[0]) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=GRAD_TOL)
    g = g_params['params']
    for name, want in (('linear_kvq.weight', g['linear_kvq']['kernel'].T),
                       ('linear.weight', g['linear']['kernel'].T),
                       ('layernorm.weight', g['layernorm']['scale']),
                       ('layernorm.bias', g['layernorm']['bias'])):
        got = dict(tm.named_parameters())[name].grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_TOL, err_msg=name)


def test_ffn_matches_flax():
    x = _x(1, (3, 16, 5))
    jm = jmod.PointwiseFeedForward(hidden_dim=16)
    params = jm.init(jax.random.PRNGKey(0), x)
    tm = mod.load_jax_params(mod.PointwiseFeedForward(16),
                             jax.tree_util.tree_map(np.asarray, params)).eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jm.apply(params, x)), atol=TOL)
    assert out.shape == (3, 16, 5) and (out >= 0).all()


def test_positional_encoding_matches_flax():
    x = _x(5, (2, 8, 20))
    jm = jmod.PositionalEncoding(dim=8, max_seq_len=100)
    params = jm.init(jax.random.PRNGKey(0), x)
    tm = mod.load_jax_params(mod.PositionalEncoding(8, 100), dict(params))
    np.testing.assert_array_equal(mod.PositionalEncoding.get_embedding(100, 8).numpy(),
                                  np.asarray(jmod.PositionalEncoding.get_embedding(100, 8)))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.apply(params, x)), atol=TOL)


def test_load_jax_params_is_strict():
    m = mod.MultiHeadAttention(16, 2)
    tree = {'linear_kvq': {'kernel': np.zeros((16, 48), np.float32)},
            'linear': {'kernel': np.ones((16, 16), np.float32)},
            'layernorm': {'scale': np.ones(16, np.float32), 'bias': np.zeros(16, np.float32)}}
    mod.load_jax_params(m, {'params': tree})
    assert float(m.linear.weight.detach().sum()) == 256.0 and m.layernorm.eps == 1e-6
    del tree['linear']
    with pytest.raises(RuntimeError, match='linear.weight'):
        mod.load_jax_params(m, tree)


def test_load_jax_params_carries_flax_embed():
    """A flax Embed's 'embedding' table (vocab, features) becomes an
    nn.Embedding's weight as it is, and looks up the same rows."""
    import flax.linen as fnn
    ids = np.random.default_rng(6).integers(0, 11, (3, 7))
    jm = fnn.Embed(11, 8)
    params = jm.init(jax.random.PRNGKey(0), ids)
    tm = torch.nn.Module()
    tm.embed = torch.nn.Embedding(11, 8)
    mod.load_jax_params(tm, {'params': {'embed': jax.tree_util.tree_map(
        np.asarray, params)['params']}})
    np.testing.assert_array_equal(tm.embed.weight.detach().numpy(),
                                  np.asarray(params['params']['embedding']))
    np.testing.assert_array_equal(tm.embed(torch.from_numpy(ids)).detach().numpy(),
                                  np.asarray(jm.apply(params, ids)))
