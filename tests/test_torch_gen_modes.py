"""The generator's training precision against the JAX package, on the CPU:
the cuDNN route's 'default' (the fp32 conv of the bf16-rounded operands, with
the mode's backward), the generator's conv geometries in 'default' on both
routes against JAX's grouped-conv kernel in interpret mode, the generator in
'default' on both routes, K2 / K4 in 'bf16x3' and 'default', and one recipe
step in JAX's modes (generator and critics 'default', K4 'bf16x3').

Inputs are made from seeds with numpy. JAX's CPU 'default' is fp32 (XLA's
DEFAULT there), so the modes are held against its Pallas kernels, which
round to bf16 inside their bodies as a TPU does. The kernels' card checks
are in ``chip_smoke.py`` phase 19.
"""

import functools

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import pytorch_sound_tpu.models.vocoders.hifi_gan  # noqa: E402,F401  (JAX's registry)
from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
from pytorch_sound_tpu.ops.pallas import grouped_conv as jax_gc  # noqa: E402
from pytorch_sound_tpu.ops.pallas.logmel import \
    fused_hifigan_mel_trainable as jax_trainable_mel  # noqa: E402
from pytorch_sound_tpu_torch.examples.hifi_gan import HiFiGANTrainer  # noqa: E402
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders import discriminators  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders import hifi_gan as hg  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import logmel as lm  # noqa: E402
from pytorch_sound_tpu_torch.trainer import adamw  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

# a mode's result against its plain version or JAX's kernel: the same
# operands rounded the same way and exact products, so only the fp32 sums'
# order differs (of the reference's max abs; tests/test_torch_critic_modes.py)
MODE_TOL = 1e-5
# ... while 'highest' sits a bf16 rounding away: at least this many times
# MODE_TOL (tests/test_torch_critic_modes.py)
MODE_APART = 10.0
FWD_TOL = 1e-5         # the generator against JAX's (tests/test_torch_generator_train.py)
GRAD_TOL = 1e-4        # its gradients, the norm of the difference over the norm
MEL_TOL = 1e-4         # K4's value and gradient against JAX's (tests/test_pallas.py:300,305)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _held(got, ref, what):
    scale = float(np.abs(ref).max())
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= MODE_TOL * scale, (what, err, scale)
    return scale


def _apart(highest, ref, scale, what):
    apart = float(np.abs(highest - ref).max())
    assert apart >= MODE_APART * MODE_TOL * scale, (what, apart, scale)


def _vjp(fn, args, g):
    """fn(*args) and the gradients of sum(fn * g) at every arg."""
    args = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*args)
    return [out.detach()] + list(torch.autograd.grad(out, args, g))


@pytest.mark.parametrize('kind', ['conv1d', 'conv2d', 'convt'])
def test_cudnn_default_route_is_the_mode(kind):
    """The cuDNN route in precision 'default' on float32 tensors (conv1d_route
    of a strided grouped conv with slope 0.1, WNConv2d's conv, the transposed
    conv of WNConvTranspose1d): forward, dx and dw within MODE_TOL of the
    plain version of the mode (the fp32 conv of the bf16-rounded x, weight
    and cotangent), and at least MODE_APART from 'highest'."""
    rng = np.random.default_rng(len(kind))
    layer = None
    if kind == 'conv1d':
        x, w, b = _rand(rng, 2, 32, 300), _rand(rng, 64, 8, 5, scale=0.2), _rand(rng, 64)
        conf = dict(stride=3, padding=2, groups=4)

        def port(x_, w_, b_, precision):
            return hg.conv1d_route(x_, w_, b_, backend='cudnn', precision=precision,
                                   slope=0.1, **conf)

        def plain(x_, w_, b_, g_):
            y = gc.grouped_conv1d_reference(x_, w_, b_, slope=0.1, precision='default',
                                            **conf)
            g_ = gc._slope_mask(g_, y, 0.1)
            return (y, gc.conv1d_input_grad_reference(g_, w_, x_.shape[2],
                                                      precision='default', **conf),
                    gc.conv1d_weight_grad_reference(x_, g_, w_.shape, precision='default',
                                                    **conf), g_.sum((0, 2)))
    elif kind == 'conv2d':
        x, w, b = _rand(rng, 2, 3, 40, 9), _rand(rng, 8, 3, 5, 3, scale=0.3), _rand(rng, 8)
        conf = dict(stride=(2, 1), padding=(2, 1))
        layer = discriminators.WNConv2d(3, 8, (5, 3), precision='default', **conf)

        def port(x_, w_, b_, precision):
            if precision == 'highest':
                return F.conv2d(x_, w_, b_, **conf)
            return hg.rounded_conv(x_, w_, b_, **conf)

        def plain(x_, w_, b_, g_):
            xo, wo, go = gc._operands('default', x_, w_, g_)
            return (F.conv2d(xo, wo, b_, **conf),
                    torch.nn.grad.conv2d_input(x_.shape, wo, go, **conf),
                    torch.nn.grad.conv2d_weight(xo, w_.shape, go, **conf), g_.sum((0, 2, 3)))
    else:
        x, w, b = _rand(rng, 2, 32, 40), _rand(rng, 32, 16, 16, scale=0.2), _rand(rng, 16)
        conf = dict(stride=8, padding=4)
        layer = hg.WNConvTranspose1d(32, 16, 16, precision='default', **conf)

        def port(x_, w_, b_, precision):
            if precision == 'highest':
                return F.conv_transpose1d(x_, w_, b_, **conf)
            return hg.rounded_conv(x_, w_, b_, transposed=True, **conf)

        def plain(x_, w_, b_, g_):
            return (gc.conv_transpose1d_reference(x_, w_, b_, precision='default', **conf),
                    gc.grouped_conv1d_reference(g_, w_, precision='default', **conf),
                    gc.conv1d_weight_grad_reference(g_, x_, w_.shape, precision='default',
                                                    **conf), g_.sum((0, 2)))
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    gy = torch.from_numpy(_rand(rng, *port(xt, wt, bt, 'highest').shape))
    got = _vjp(lambda *a: port(*a, 'default'), (xt, wt, bt), gy)
    high = _vjp(lambda *a: port(*a, 'highest'), (xt, wt, bt), gy)
    refs = plain(xt, wt, bt, gy)
    for name, a, h, ref in zip(('y', 'dx', 'dw', 'db'), got, high, refs):
        scale = _held(a.numpy(), ref.numpy(), (kind, name))
        if name != 'db':        # the bias' gradient takes no rounding
            _apart(h.numpy(), ref.numpy(), scale, (kind, name))
    if layer is not None:       # the module runs the route on its folded weight
        with torch.no_grad():
            want = port(xt, layer.folded_weight(), layer.bias, 'default')
            assert torch.equal(layer(xt), want)


# the generator's distinct conv geometries, (name, n, t, cin, cout, k, stride,
# padding, dilation, slope) at T <= 256: conv_pre from 80 mel channels, a
# dilated convs1 with ResBlock1's fused slope, convs2, an upsample
# (transposed, k16 s8) and conv_post to one channel
GEN_GEOMETRIES = [
    pytest.param(2, 64, 80, 32, 7, 1, 3, 1, None, id='conv_pre_k7'),
    pytest.param(2, 256, 16, 16, 11, 1, 25, 5, 0.1, id='convs1_k11_d5'),
    pytest.param(2, 256, 16, 16, 3, 1, 1, 1, None, id='convs2_k3'),
    pytest.param(2, 32, 32, 16, 16, 8, 4, 1, None, id='ups_k16_s8'),
    pytest.param(2, 256, 16, 1, 7, 1, 3, 1, None, id='conv_post_k7'),
]


@pytest.mark.parametrize('n,t,cin,cout,k,s,p,d,slope', GEN_GEOMETRIES)
def test_generator_geometry_matches_the_pallas_kernel(n, t, cin, cout, k, s, p, d, slope):
    """Each generator geometry's forward (bias, and slope where fused) and
    VJP (dx, dw, db) in precision 'default' on both routes (K6's plain
    version, 'cuda'; the repaired cuDNN route, 'cudnn'), as the generator's
    layers call them, against JAX's grouped-conv kernel in interpret mode at
    precision='default' (``conv_transpose1d_ntc`` for the upsample,
    conv_post through its private kernel function, since the public entry
    leaves one-row groups to XLA); and 'highest' MODE_APART away."""
    transposed = s > 1
    rng = np.random.default_rng(n + t + cin + cout + k + d)
    x = _rand(rng, n, t, cin)                                        # NTC
    w = _rand(rng, *((cin, cout, k) if transposed else (cout, cin, k)),
              scale=(cin * k) ** -0.5)
    b = _rand(rng, cout, scale=0.1)
    if transposed:
        def jax_conv(x_, w_, b_):
            return jax_gc.conv_transpose1d_ntc(x_, w_, b_, stride=s, padding=p,
                                               precision='default', interpret=True)
    elif jax_gc.eligible(cin, cout, k, s, 1, t, p, d):
        def jax_conv(x_, w_, b_):
            return jax_gc.grouped_conv1d_ntc(x_, w_, b_, stride=s, padding=p, dilation=d,
                                             slope=slope, backend='pallas',
                                             precision='default', interpret=True)
    else:
        def jax_conv(x_, w_, b_):
            return jax_gc._pallas_grouped_conv(x_, w_, b_, s, p, 1, d, slope, 'default',
                                               True)
    y_ref, vjp = jax.vjp(jax_conv, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    gy = _rand(rng, *y_ref.shape)                                    # NTC
    refs = [np.asarray(y_ref)] + [np.asarray(a) for a in vjp(jnp.asarray(gy))]

    def nct(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))

    def port(backend, precision):
        if transposed:
            layer = hg.WNConvTranspose1d(cin, cout, k, s, padding=p, use_weight_norm=False,
                                         backend=backend, precision=precision)
        else:
            layer = hg.WNConv1d(cin, cout, k, dilation=d, padding=p, use_weight_norm=False,
                                fused_slope=slope, backend=backend, precision=precision)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w))
            layer.bias.copy_(torch.from_numpy(b))
        xt = nct(x).requires_grad_(True)
        y = layer(xt)
        y.backward(nct(gy))
        return [y.detach().numpy().transpose(0, 2, 1), xt.grad.numpy().transpose(0, 2, 1),
                layer.weight.grad.numpy(), layer.bias.grad.numpy()]

    highest = port('cudnn', 'highest')
    for backend in ('cuda', 'cudnn'):
        for name, got, h, ref in zip(('y', 'dx', 'dw', 'db'), port(backend, 'default'),
                                     highest, refs):
            scale = _held(got, ref, (backend, name))
            if name != 'db':        # the bias' gradient takes no rounding
                _apart(h, ref, scale, (backend, name))


def _mel(seed, frames):
    return (np.random.default_rng(seed).standard_normal((2, 80, frames)) * 2 - 4
            ).astype(np.float32)


def _gen_tree(arch, extra, mel, seed):
    """The JAX generator's (g, v) tree filled from a seed (v ~ N(0, 1), g ~
    U(0.2, 0.6), small biases), as tests/test_torch_generator_train.py
    fills it."""
    jgen = jax_build_model(arch, extra_kwargs=extra)
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.asarray(mel))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1])
        if "'g'" in name:
            return rng.uniform(0.2, 0.6, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * (0.05 if "'bias'" in name else 1.0)
                ).astype(np.float32)
    return jgen, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize('arch,extra', [
    ('hifi_gan_v3', {'upsample_initial_channel': 32}),        # ResBlock2
    ('hifi_gan_v2', {'upsample_initial_channel': 32}),        # ResBlock1, C = 16 ... 2
])
def test_generator_modes_on_both_routes(arch, extra):
    """The generator from JAX's (g, v) tree: at 'highest' on the K6 route
    (every conv on the grouped-conv functions, ResBlock1's mid-block slope
    fused into convs1) as on cuDNN, and both equal to JAX's generator (FWD_TOL,
    GRAD_TOL, as tests/test_torch_generator_train.py); in 'default' the K6
    route equal to the cuDNN route (the same rounded operands), both apart
    from 'highest'. The parameter names stay those of 'highest'."""
    mel = _mel(len(arch), 8)
    jgen, params = _gen_tree(arch, extra, mel, seed=11)
    r = _rand(np.random.default_rng(2), 2, 1, 8 * int(np.prod(jgen.upsample_rates)))

    def jax_loss(p):
        out = jgen.apply(p, jnp.asarray(mel))
        return jnp.sum(out * r), out

    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    ref_grads = hg.load_jax_params(jax.tree_util.tree_map(np.asarray, ref_grads),
                                   weight_norm=True)
    runs = {}
    for backend in ('cudnn', 'cuda'):
        for precision in ('highest', 'default'):
            gen = build_model(arch, extra_kwargs=dict(extra, backend=backend,
                                                      ups_backend=backend,
                                                      precision=precision))
            gen.load_state_dict(hg.load_jax_params(params, weight_norm=True))
            out = gen(torch.from_numpy(mel))
            torch.sum(out * torch.from_numpy(r)).backward()
            runs[backend, precision] = (out.detach().numpy(),
                                        {k: v.grad for k, v in gen.named_parameters()})
    assert set(runs['cuda', 'default'][1]) == set(ref_grads)
    for backend in ('cudnn', 'cuda'):
        out, grads = runs[backend, 'highest']
        np.testing.assert_allclose(out, np.asarray(ref_out), rtol=FWD_TOL, atol=FWD_TOL)
        for key, want in ref_grads.items():
            err = float((grads[key] - want).norm() / max(float(want.norm()), 1e-30))
            assert err <= GRAD_TOL, (backend, key, err)
    (out_k, grads_k), (out_c, grads_c) = runs['cuda', 'default'], runs['cudnn', 'default']
    scale = float(np.abs(out_c).max())
    assert float(np.abs(out_k - out_c).max()) <= MODE_TOL * scale
    assert float(np.abs(runs['cudnn', 'highest'][0] - out_c).max()) >= \
        MODE_APART * MODE_TOL * scale
    for key, want in grads_c.items():
        err = float((grads_k[key] - want).norm() / max(float(want.norm()), 1e-30))
        assert err <= MODE_TOL, (key, err)


@functools.lru_cache(maxsize=None)
def _jax_mels(signal):
    """(wav, {mode: (JAX's K4 value, its gradient of sum(sin(mel)))}) in
    interpret mode, for the noise and tone cases."""
    rng = np.random.default_rng(21)
    if signal == 'noise':
        wav = (rng.standard_normal((2, 9000)) * 0.2).astype(np.float32)
    else:
        t = np.arange(9000) / 22050
        wav = np.stack([0.3 * np.sin(2 * np.pi * 220 * t),
                        0.2 * np.sin(2 * np.pi * 440 * t)
                        + 0.001 * rng.standard_normal(9000)]).astype(np.float32)
    out = {}
    for mode in lm.PRECISIONS:
        value, vjp = jax.vjp(lambda w, m=mode: jax_trainable_mel(w, m), jnp.asarray(wav))
        out[mode] = (np.asarray(value), np.asarray(vjp(jnp.cos(value))[0]))
    return wav, out


@pytest.mark.parametrize('signal', ['noise', 'tones'])
def test_mel_modes_against_jax(signal):
    """K4 (``fused_hifigan_mel_trainable``) and K2 (``fused_hifigan_mel``) in
    'bf16x3' and 'default' against JAX's K4 in that mode (interpret mode),
    at test_torch_mel.py::test_precision_modes_against_jax_bf16x3's bounds:
    'bf16x3' within 1e-4 on noise and 0.1 on tones, and at least as near
    fp64 as JAX's 'bf16x3' (the port computes every mode as 'highest', bit
    for bit); 'default', which JAX's CPU contraction runs in fp32, within
    1e-4 and 5e-3, as 'highest'. The gradient is the composite's VJP in
    every mode: equal to the 'highest' gradient, and on noise within MEL_TOL
    of JAX's (the tones' near-silent bands give gradients of ~1e4 through
    1 / sqrt(power + 1e-9), where the two packages' fp32 composites part by
    more than their values do)."""
    wav, ref = _jax_mels(signal)
    fp64 = lm.fused_hifigan_mel(torch.from_numpy(wav).double()).numpy()
    got = {}
    for mode in lm.PRECISIONS:
        w = torch.from_numpy(wav).requires_grad_(True)
        out = lm.fused_hifigan_mel_trainable(w, mode)
        torch.sum(torch.sin(out)).backward()
        got[mode] = (out.detach().numpy(), w.grad.numpy())
        assert torch.equal(lm.fused_hifigan_mel(torch.from_numpy(wav), precision=mode),
                           out.detach())
    bounds = {'bf16x3': 0.1, 'default': 5e-3, 'highest': 5e-3} if signal == 'tones' else \
        dict.fromkeys(lm.PRECISIONS, 1e-4)
    for mode in lm.PRECISIONS:
        value, grad = got[mode]
        ref_value, ref_grad = ref[mode]
        assert value.shape == ref_value.shape == (2, 80, 35)
        assert np.array_equal(value, got['highest'][0]) and np.array_equal(grad, got['highest'][1])
        assert float(np.abs(value - ref_value).max()) <= bounds[mode], mode
        if signal == 'noise':
            np.testing.assert_allclose(grad, ref_grad, atol=MEL_TOL, rtol=0)
    assert np.abs(got['bf16x3'][0] - fp64).max() <= np.abs(ref['bf16x3'][0] - fp64).max()
    for bad in ('fp8', None):
        with pytest.raises(ValueError, match='precision'):
            lm.fused_hifigan_mel_trainable(torch.from_numpy(wav), bad)


def test_recipe_step_in_jax_modes(tmp_path):
    """One HiFiGANTrainer step in JAX's recipe modes (generator and critics in
    'default', K2 / K4 in 'bf16x3'; v3 at 32 channels, MPD small, MSD small,
    2 x 2048) on the cuDNN route and on the K6 route (every generator and
    critic conv on the grouped-conv functions): the same loss within 1e-5,
    every gradient within MODE_TOL (norm of the difference over the norm)
    and every parameter within 1e-6 on both routes; the gradients a bf16
    rounding apart from the 'highest' step's."""
    batch = (np.random.default_rng(17).standard_normal((2, 2048)) * 0.2).astype(np.float32)
    outs = {}
    for route, precision, mel in (('cudnn', 'default', 'bf16x3'), ('cuda', 'default', 'bf16x3'),
                                  ('cudnn', 'highest', 'highest')):
        torch.manual_seed(13)
        gen = build_model('hifi_gan_v3', extra_kwargs={
            'upsample_initial_channel': 32, 'backend': route, 'ups_backend': route,
            'precision': precision})
        mpd, msd = (build_model(arch, extra_kwargs={'backends': (route,) * 8,
                                                    'precision': precision})
                    for arch in ('hifi_gan_mpd_small', 'hifi_gan_msd_small'))
        t = HiFiGANTrainer(gen, mpd, msd, adamw(gen.parameters(), 2e-4),
                           adamw(list(mpd.parameters()) + list(msd.parameters()), 2e-4),
                           None, None, max_step=1, valid_max_step=1, save_interval=10 ** 9,
                           log_interval=10 ** 9, save_dir=str(tmp_path), seed=13,
                           device='cpu', mel_precision=mel)
        loss, _ = t._train_step([torch.from_numpy(batch)], is_logging=False)
        assert np.isfinite(float(loss))
        named = [('%s.%s' % (m, k), v) for m, mod in (('gen', gen), ('mpd', mpd), ('msd', msd))
                 for k, v in mod.named_parameters()]
        outs[route, precision] = (float(loss), {k: v.detach().clone() for k, v in named},
                                  {k: v.grad.clone() for k, v in named})

    def grad_rel(a, b):
        return max(float((a[k] - b[k]).norm() / max(float(b[k].norm()), 1e-30)) for k in b)
    (l0, p0, g0), (l1, p1, g1) = outs['cudnn', 'default'], outs['cuda', 'default']
    assert abs(l0 - l1) <= 1e-5 * max(1.0, abs(l0))
    assert max(float((p0[k] - p1[k]).abs().max()) for k in p0) <= 1e-6
    assert grad_rel(g1, g0) <= MODE_TOL
    assert grad_rel(outs['cudnn', 'highest'][2], g0) >= MODE_APART * MODE_TOL
    with pytest.raises(ValueError, match='mel_precision'):
        HiFiGANTrainer(gen, mpd, msd, adamw(gen.parameters(), 2e-4),
                       adamw(mpd.parameters(), 2e-4), None, None, max_step=1,
                       valid_max_step=1, save_interval=1, log_interval=1,
                       save_dir=str(tmp_path), device='cpu', mel_precision='fp8')
