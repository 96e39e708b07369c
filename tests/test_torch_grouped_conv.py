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

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.ops.pallas.grouped_conv import (  # noqa: E402
    conv_transpose1d_ntc, grouped_conv1d_ntc)
from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc  # noqa: E402

SLOPE = 0.1
FWD_TOL = 2e-5
GRAD_TOL = 3e-4


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
    weight is small, and little when it is large."""
    assert gc.dw_tile(128) == (128, 64) and gc.dw_tile(1) == (1, 32)
    sms = 132                                                     # H100 SXM
    assert gc.dw_splits(128, 1, 15, 1, 32 * 8192, sms) == 1024    # MSD L0: 1 tile
    assert gc.dw_splits(1024, 128, 41, 8, 32 * 128, sms) == 2     # MSD L5: 656 tiles
    assert gc.dw_splits(32, 1, 5, 1, 352 * 249, sms) == 342       # MPD L0 at p = 11
    assert gc.dw_splits(32, 1, 5, 1, 100, sms) == 1               # short: one chunk
