"""The critics' fast modes against the JAX package, on the CPU: K6 in
precision 'default' (each operand rounded to bf16, fp32 sums), the critics
on bfloat16 activations (``compute_dtype='bf16'``), ``WNConv2d``, and the
folded MSD (``msd_apply_folded``) with the recipe's ``msd_folded`` step.

Inputs are made from seeds with numpy. The port keeps feature maps
channels-first; they are mapped to the JAX package's channels-last layout
before they are compared. The kernels' card checks are in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 18.
"""

import functools

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pytorch_sound_tpu.models.vocoders.discriminators as jax_disc  # noqa: E402
from pytorch_sound_tpu.ops.pallas import grouped_conv as jax_gc  # noqa: E402
from pytorch_sound_tpu_torch.examples.hifi_gan import HiFiGANTrainer  # noqa: E402
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders import discriminators  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import load_jax_params  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc  # noqa: E402
from pytorch_sound_tpu_torch.trainer import adamw  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

# K6 'default', the port's plain version against JAX's kernel in interpret
# mode: the same operands rounded the same way and exact products, so only
# the fp32 sums' order differs (of the JAX output's max abs)
MODE_TOL = 1e-5
# ... while 'highest' sits a bf16 rounding away: at least this many times
# MODE_TOL (a bf16 operand is ~2^-9 off; measured 1.7e-3 to 3.6e-3 of the
# max, against 5e-9 to 2.6e-7 for 'default')
MODE_APART = 10.0
FOLD_TOL = 2e-5        # folded vs unfolded MSD (tests/test_hifigan_training.py:310)
FOLD_GRAD_RTOL, FOLD_GRAD_ATOL = 5e-4, 5e-5   # its gradients (:342-343)
STEP_LOSS_TOL, STEP_PARAM_TOL = 1e-4, 1e-5    # msd_folded step vs unfolded (:398-401)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# (n, t, cin, cout, k, stride, groups, padding) at T <= 256: a strided grouped
# k41 layer at a quarter of MSD L1's width, a dense MPD-like k5 s3 layer, and
# conv_post (one row per group, which JAX's public entry leaves to XLA:
# its kernel is called as grouped_conv1d_ntc calls it for eligible shapes)
K6_GEOMETRIES = [pytest.param(2, 256, 32, 32, 41, 2, 4, 20, id='k41_s2_g4'),
                 pytest.param(4, 96, 16, 32, 5, 3, 1, 2, id='mpd_k5_s3'),
                 pytest.param(2, 64, 64, 1, 3, 1, 1, 1, id='conv_post')]


@pytest.mark.parametrize('n,t,cin,cout,k,s,g,p', K6_GEOMETRIES)
def test_default_mode_matches_the_pallas_kernel(n, t, cin, cout, k, s, g, p):
    """The forward (bias, leaky_relu 0.1) and its VJP (dx, dw) of the port's
    K6 in precision 'default' (the plain versions, which the CPU runs)
    against JAX's grouped-conv kernel in interpret mode at
    precision='default', which casts x, w and the cotangent to bf16 inside
    the kernel; NTC <-> NCT transposed explicitly."""
    rng = np.random.default_rng(n + t + cin + cout + k)
    x = _rand(rng, n, t, cin)                                    # NTC
    w = _rand(rng, cout, cin // g, k, scale=(cin // g * k) ** -0.5)
    b = _rand(rng, cout, scale=0.1)
    slope = None if cout == 1 else 0.1
    if jax_gc.eligible(cin, cout, k, s, g, t, p):
        def jax_conv(x_, w_, b_):
            return jax_gc.grouped_conv1d_ntc(x_, w_, b_, stride=s, padding=p, groups=g,
                                             slope=slope, backend='pallas',
                                             precision='default', interpret=True)
    else:
        def jax_conv(x_, w_, b_):
            return jax_gc._pallas_grouped_conv(x_, w_, b_, s, p, g, 1, slope, 'default', True)
    y_ref, vjp = jax.vjp(jax_conv, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    gy = _rand(rng, *y_ref.shape)                                # NTC
    dx_ref, dw_ref, _ = (np.asarray(a) for a in vjp(jnp.asarray(gy)))
    y_ref = np.asarray(y_ref)

    def nct(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))

    xt, wt, bt = nct(x), torch.from_numpy(w), torch.from_numpy(b)
    # the cotangent through the slope as JAX's VJP takes it, from its output
    # (a sign flipped at an output ~0 would move dx and dw by far more than
    # the products' rounding)
    gyt = gc._slope_mask(nct(gy), nct(y_ref), slope)
    conf = dict(stride=s, padding=p, groups=g)
    got, highest = {}, {}
    for mode, out in (('default', got), ('highest', highest)):
        y = gc.conv1d_forward(xt, wt, bt, slope=slope, precision=mode, **conf)
        out['y'] = y.numpy().transpose(0, 2, 1)
        out['dx'] = gc.conv1d_input_grad(gyt, wt, t, precision=mode, **conf) \
            .numpy().transpose(0, 2, 1)
        out['dw'] = gc.conv1d_weight_grad(xt, gyt, wt.shape, precision=mode, **conf).numpy()
    for key, ref in (('y', y_ref), ('dx', dx_ref), ('dw', dw_ref)):
        scale = float(np.abs(ref).max())
        err = float(np.abs(got[key] - ref).max())
        apart = float(np.abs(highest[key] - ref).max())
        assert got[key].shape == ref.shape, key
        assert err <= MODE_TOL * scale, (key, err, scale)
        assert apart >= MODE_APART * MODE_TOL * scale, (key, apart, scale)


def _jax_params(module, x, seed):
    """The JAX module's (g, v) tree from eval_shape, filled from a seed:
    v ~ N(0, 1), g ~ U(0.3, 1.2), small biases."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1])
        if "'g'" in name:
            return rng.uniform(0.3, 1.2, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * (0.05 if "'bias'" in name else 1.0)
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_layout(feature):
    """A port feature map -> the JAX package's channels-last layout."""
    return feature.detach().float().numpy().swapaxes(-1, -2)


# bf16 critics, port vs JAX: both round every layer's output to bf16, at
# different places (JAX's XLA route rounds the conv, adds the bias in f32 and
# rounds again, as the port's cuDNN route does; its K6 route rounds once),
# and a rounding that differs in one layer moves the next by a bf16 ulp of
# its inputs. So each map and score within 2^-5 of its max abs (8 ulps of
# its largest entry; measured 0 to 0.0113, and the fp32 critics 0.0109:
# the bf16 dtypes are asserted apart)
BF16_TOL = 2 ** -5


@functools.lru_cache(maxsize=None)
def _jax_bf16_critics():
    """(x, [(arch, params, JAX's bf16 outputs)]) for MSD small and MPD small,
    computed once for both routes' cases."""
    x = _rand(np.random.default_rng(9), 2, 1, 2048, scale=0.5)
    out = []
    for arch, jmod in (('hifi_gan_msd_small', jax_disc.MultiScaleDiscriminator(
                           n_scales=2, width=0.0625, compute_dtype='bf16')),
                       ('hifi_gan_mpd_small', jax_disc.MultiPeriodDiscriminator(
                           periods=(2, 3), channels=(8, 16), compute_dtype='bf16'))):
        params = _jax_params(jmod, jnp.asarray(x), seed=len(arch))
        out.append((arch, params, jax.jit(jmod.apply)(params, jnp.asarray(x))))
    return x, out


@pytest.mark.parametrize('route', ['cudnn', 'cuda'])
def test_bf16_critics_match_jax(route):
    """MPD small and MSD small with compute_dtype='bf16' against JAX's bf16
    critics from the same parameters (load_jax_params): bf16 scores and
    features within BF16_TOL, and the gradients at the parameters fp32 (the
    master weights), as tests/test_hifigan_training.py:346-370 holds JAX's."""
    x, critics = _jax_bf16_critics()
    for arch, params, ref in critics:
        model = build_model(arch, extra_kwargs={'backends': (route,) * 8,
                                                'compute_dtype': 'bf16'})
        model.load_state_dict(load_jax_params(params, weight_norm=True))
        got = model(torch.from_numpy(x))
        for (s_g, f_g), (s_r, f_r) in zip(got, ref):
            assert s_g.dtype == torch.bfloat16 and s_r.dtype == jnp.bfloat16
            pairs = [(s_g.detach().float().numpy(), np.asarray(s_r, np.float32))]
            pairs += [(_jax_layout(a), np.asarray(b, np.float32)) for a, b in zip(f_g, f_r)]
            for a, b in pairs:
                assert a.shape == b.shape
                scale = float(np.abs(b).max())
                assert float(np.abs(a - b).max()) <= BF16_TOL * scale, (arch, route)
        sum(torch.mean(s.float() ** 2) for s, _ in got).backward()
        for name, prm in model.named_parameters():
            assert prm.grad is not None and prm.grad.dtype == torch.float32, name
            assert bool(torch.isfinite(prm.grad).all()), name


@pytest.mark.parametrize('precision,compute_dtype,tol', [
    ('highest', None, 1e-5),          # fp32 on both sides
    ('default', None, 2 ** -7),       # JAX's CPU 'default' is fp32; the port rounds the operands
    ('default', 'bf16', 2 ** -7),     # both bf16 operands and outputs
])
def test_wnconv2d_matches_jax(precision, compute_dtype, tol):
    """WNConv2d's parameters load from JAX's tree as they stand (v in OIHW),
    and its output matches JAX's WNConv2d in each mode (of the max abs)."""
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 3, 20, 9)
    jmod = jax_disc.WNConv2d(3, 8, (5, 3), stride=(2, 1), padding=(2, 1),
                             precision=precision, compute_dtype=compute_dtype)
    params = _jax_params(jmod, jnp.asarray(x), seed=5)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)), np.float32)
    conv = discriminators.WNConv2d(3, 8, (5, 3), stride=(2, 1), padding=(2, 1),
                                   precision=precision, compute_dtype=compute_dtype)
    state = load_jax_params(params, weight_norm=True)
    assert state['v'].shape == (8, 3, 5, 3) and state['g'].shape == (8, 1, 1, 1)
    conv.load_state_dict(state)
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    assert got.dtype == (torch.bfloat16 if compute_dtype else torch.float32)
    assert got.shape == ref.shape
    assert float((got.float().numpy() - ref).__abs__().max()) <= tol * float(np.abs(ref).max())


def _msd(n_scales, width, route='cudnn', seed=3):
    """A port MSD with (g, v) weights from a seed at the JAX init's scale."""
    torch.manual_seed(seed)
    msd = discriminators.MultiScaleDiscriminator(n_scales, width, (route,) * 8)
    with torch.no_grad():
        for name, prm in msd.named_parameters():
            prm.copy_(torch.randn(prm.shape) * (0.05 if name.endswith('bias') else 0.3)
                      if not name.endswith('.g') else torch.rand(prm.shape) + 0.3)
    return msd


def _held(got, ref, tol, layout=lambda a: a):
    assert len(got) == len(ref)
    for (s_g, f_g), (s_r, f_r) in zip(got, ref):
        np.testing.assert_allclose(s_g.detach().numpy(), np.asarray(s_r), rtol=tol, atol=tol)
        assert len(f_g) == len(f_r)
        for a, b in zip(f_g, f_r):
            a = layout(a)
            assert a.shape == np.asarray(b).shape
            np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize('n_scales,width', [(3, 0.0625), (2, 0.125)])
def test_folded_msd_matches_jax(n_scales, width):
    """The port's msd_apply_folded against JAX's at T = 2048, from the same
    parameters: every score and feature map within FOLD_TOL."""
    x = _rand(np.random.default_rng(7), 2, 1, 2048)
    jmsd = jax_disc.MultiScaleDiscriminator(n_scales=n_scales, width=width)
    params = _jax_params(jmsd, jnp.asarray(x), seed=n_scales)
    ref = jax.jit(lambda p, w: jax_disc.msd_apply_folded(jmsd, p, w))(params, jnp.asarray(x))
    msd = discriminators.MultiScaleDiscriminator(n_scales, width)
    msd.load_state_dict(load_jax_params(params, weight_norm=True))
    with torch.no_grad():
        got = discriminators.msd_apply_folded(msd, torch.from_numpy(x))
    _held(got, ref, FOLD_TOL, _jax_layout)


def test_folded_msd_matches_unfolded():
    """msd_apply_folded against the port's own unfolded MSD at full width
    (the wide groups, cin / groups of 32 to 128) on a short wave: outputs
    within FOLD_TOL, and the gradients of a loss over every score and map
    at every parameter within FOLD_GRAD_RTOL / FOLD_GRAD_ATOL (the padded
    tails add nothing to dw or db). On the cuda route: the folded layers run
    the grouped-conv functions (their plain forward, dx and dw here) with
    n_scales x groups groups; the cuDNN route is held to JAX's folded MSD
    above, and both routes on the card in chip_smoke.py phase 18."""
    msd = _msd(3, 1.0, 'cuda')
    x = torch.from_numpy(_rand(np.random.default_rng(8), 2, 1, 512))
    runs = []
    for apply in (msd, lambda w: discriminators.msd_apply_folded(msd, w)):
        msd.zero_grad()
        outs = apply(x)
        sum(torch.mean(s ** 2) + sum(torch.mean(f.abs()) for f in feats)
            for s, feats in outs).backward()
        runs.append((outs, {k: p.grad.clone() for k, p in msd.named_parameters()}))
    (ref, g_ref), (got, g_got) = runs
    _held(got, [(s.detach().numpy(), [f.detach().numpy() for f in feats]) for s, feats in ref],
          FOLD_TOL, lambda a: a.detach().numpy())
    for key, want in g_ref.items():
        np.testing.assert_allclose(g_got[key].numpy(), want.numpy(), rtol=FOLD_GRAD_RTOL,
                                   atol=FOLD_GRAD_ATOL, err_msg=key)


def test_msd_folded_step_matches_unfolded(tmp_path):
    """HiFiGANTrainer(msd_folded=True)'s first step equals the unfolded
    one's: the loss within STEP_LOSS_TOL, every parameter within
    STEP_PARAM_TOL (v3 at 32 channels, MPD small, MSD small, 2 x 2048; JAX's
    test_hifigan_msd_folded_step_matches_unfolded)."""
    batch = [(np.random.default_rng(17).standard_normal((2, 2048)) * 0.2).astype(np.float32)]
    outs = []
    for folded in (False, True):
        torch.manual_seed(13)
        gen = build_model('hifi_gan_v3', extra_kwargs={'upsample_initial_channel': 32})
        mpd, msd = build_model('hifi_gan_mpd_small'), build_model('hifi_gan_msd_small')
        t = HiFiGANTrainer(gen, mpd, msd, adamw(gen.parameters(), 2e-4),
                           adamw(list(mpd.parameters()) + list(msd.parameters()), 2e-4),
                           None, None, max_step=1, valid_max_step=1, save_interval=10 ** 9,
                           log_interval=10 ** 9, save_dir=str(tmp_path), seed=13,
                           device='cpu', msd_folded=folded)
        loss, _ = t._train_step([torch.from_numpy(batch[0])], is_logging=False)
        outs.append((float(loss), {'%s.%s' % (m, k): v.detach().clone()
                                   for m, mod in (('gen', gen), ('mpd', mpd), ('msd', msd))
                                   for k, v in mod.state_dict().items()}))
    (l0, p0), (l1, p1) = outs
    assert abs(l0 - l1) < STEP_LOSS_TOL * max(1.0, abs(l0))
    assert max(float((p0[k] - p1[k]).abs().max()) for k in p0) < STEP_PARAM_TOL
