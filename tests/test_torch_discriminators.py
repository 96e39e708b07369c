"""The port's HiFi-GAN critics (MPD / MSD) and GAN losses against the JAX
package's, on the CPU, from the same parameters and inputs made from a seed.

The port keeps feature maps channels-first: a period discriminator's are
(N, P, C, H) where JAX's are (N, P, H, C), a scale discriminator's (N, C, T)
where JAX's are (N, T, C). They are mapped before they are compared.
"""

import functools

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
import pytorch_sound_tpu.models.vocoders.discriminators  # noqa: E402,F401
from pytorch_sound_tpu.ops import gan as jax_gan  # noqa: E402
from pytorch_sound_tpu_torch.examples.hifi_gan import HiFiGANTrainer  # noqa: E402
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import load_jax_params  # noqa: E402
from pytorch_sound_tpu_torch.ops import gan as gan_ops  # noqa: E402

FWD_TOL = 1e-5         # scores and feature maps
GRAD_TOL = 1e-4        # norm of the gradient difference over the gradient's norm


def jax_params(module, x, seed):
    """The JAX module's (g, v) tree (shapes from eval_shape, no init
    compile), filled from a seed: v ~ N(0, 1), g ~ U(0.3, 1.2) (each weight
    row's norm), small biases."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1])
        if "'g'" in name:
            return rng.uniform(0.3, 1.2, s.shape).astype(np.float32)
        scale = 0.05 if "'bias'" in name else 1.0
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def flat(tree, prefix=''):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, prefix + key + '.'))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def port_model(arch, params, route='cudnn'):
    """The port's critic with every conv on ``route``: 'cudnn' (F.conv1d) or
    'cuda' (the grouped-conv autograd functions, on the CPU through their
    plain forward, dx and dw)."""
    model = build_model(arch, extra_kwargs={'backends': (route,) * 8})
    model.load_state_dict(load_jax_params(params, weight_norm=True))
    return model


def to_jax_layout(feature):
    """Port feature map -> the JAX package's channels-last layout (numpy)."""
    return feature.detach().numpy().swapaxes(-1, -2)


def wav(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


CASES = [('hifi_gan_mpd_small', (2, 1, 2048)), ('hifi_gan_msd_small', (2, 1, 2048)),
         ('hifi_gan_mpd_base', (1, 1, 1024)), ('hifi_gan_msd_base', (1, 1, 1024))]
# each case on both conv routes; the cuDNN route keeps the ids it always had
ROUTE_CASES = [pytest.param(arch, shape, route,
                            id='%s-shape%d%s' % (arch, i, '' if route == 'cudnn' else '-cuda'))
               for route in ('cudnn', 'cuda') for i, (arch, shape) in enumerate(CASES)]


@functools.lru_cache(maxsize=None)
def jax_forward(arch, shape):
    """(x, params, the JAX critic's outputs), computed once per (arch, shape)
    for both routes' cases."""
    x = wav(len(arch), shape)
    jmod = jax_build_model(arch)
    params = jax_params(jmod, jnp.asarray(x), seed=len(arch) + 1)
    return x, params, jax.jit(jmod.apply)(params, jnp.asarray(x))


@functools.lru_cache(maxsize=None)
def jax_loss_grads(arch, shape):
    """(x1, x2, params, loss, flat grads) of LSGAN + feature matching between
    two inputs, computed once per (arch, shape) for both routes' cases."""
    x1, x2 = wav(1, shape), wav(2, shape)
    jmod = jax_build_model(arch)
    params = jax_params(jmod, jnp.asarray(x1), seed=3)

    def jax_loss(p):
        a, b = jmod.apply(p, jnp.asarray(x1)), jmod.apply(p, jnp.asarray(x2))
        return jax_gan.discriminator_loss(a, b) + jax_gan.feature_matching_loss(a, b)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    return x1, x2, params, float(ref_loss), flat(ref_grads['params'])


@pytest.mark.parametrize('arch,shape,route', ROUTE_CASES)
def test_critic_matches_jax(arch, shape, route):
    x, params, ref = jax_forward(arch, shape)
    model = port_model(arch, params, route)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(ref)
    for (s_g, f_g), (s_r, f_r) in zip(got, ref):
        assert tuple(s_g.shape) == s_r.shape
        np.testing.assert_allclose(s_g.numpy(), np.asarray(s_r), atol=FWD_TOL, rtol=0)
        assert len(f_g) == len(f_r)
        for a, b in zip(f_g, f_r):
            a = to_jax_layout(a)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, np.asarray(b), atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize('arch,shape,route', ROUTE_CASES)
def test_critic_grads_match_jax(arch, shape, route):
    """d/d(every g, v, bias) of LSGAN + feature matching between two inputs."""
    x1, x2, params, ref_loss, ref_grads = jax_loss_grads(arch, shape)
    model = port_model(arch, params, route)
    a, b = model(torch.from_numpy(x1)), model(torch.from_numpy(x2))
    loss = gan_ops.discriminator_loss(a, b) + gan_ops.feature_matching_loss(a, b)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert grads.keys() == ref_grads.keys()
    for key, ref in ref_grads.items():
        err = np.linalg.norm(grads[key] - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= GRAD_TOL, (key, err)


def test_batched_pass_equals_two_passes(tmp_path):
    """HiFiGANTrainer._apply_both (one pass over cat([real, fake])) equals two
    separate critic passes: scores and every feature map."""
    torch.manual_seed(0)
    real = torch.from_numpy(wav(3, (2, 1, 1024)))
    fake = torch.from_numpy(wav(4, (2, 1, 1024)))
    for arch in ('hifi_gan_mpd_small', 'hifi_gan_msd_small'):
        disc = build_model(arch)
        with torch.no_grad():
            r_out, f_out = HiFiGANTrainer._apply_both(disc, real, fake)
            r_ref, f_ref = disc(real), disc(fake)
        for got, ref in ((r_out, r_ref), (f_out, f_ref)):
            for (s_g, feats_g), (s_r, feats_r) in zip(got, ref):
                torch.testing.assert_close(s_g, s_r, atol=1e-5, rtol=0)
                for a, b in zip(feats_g, feats_r):
                    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(5)

    def outs():
        return [(rng.standard_normal((2, 10)).astype(np.float32),
                 [rng.standard_normal((2, 4, 8)).astype(np.float32),
                  rng.standard_normal((2, 3, 5)).astype(np.float32)])
                for _ in range(3)]

    real, fake = outs(), outs()

    def conv(o, fn):
        return [(fn(s), [fn(f) for f in feats]) for s, feats in o]

    pt = {k: conv(v, torch.from_numpy) for k, v in (('r', real), ('f', fake))}
    jx = {k: conv(v, jnp.asarray) for k, v in (('r', real), ('f', fake))}
    pairs = [(gan_ops.discriminator_loss(pt['r'], pt['f']),
              jax_gan.discriminator_loss(jx['r'], jx['f'])),
             (gan_ops.generator_adversarial_loss(pt['f']),
              jax_gan.generator_adversarial_loss(jx['f'])),
             (gan_ops.feature_matching_loss(pt['r'], pt['f']),
              jax_gan.feature_matching_loss(jx['r'], jx['f']))]
    for got, ref in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)

    # the JAX suite's behaviour check (tests/test_hifigan_training.py:40)
    one = [(torch.ones((2, 10)), [torch.ones((2, 4, 8))])]
    zero = [(torch.zeros((2, 10)), [torch.zeros((2, 4, 8))])]
    assert float(gan_ops.discriminator_loss(one, zero)) == 0.0
    assert float(gan_ops.generator_adversarial_loss(zero)) == 1.0
    assert float(gan_ops.feature_matching_loss(one, zero)) == 1.0


def test_registry_and_shapes():
    """The JAX archs' names, and the shapes of tests/test_hifigan_training.py:21."""
    from pytorch_sound_tpu_torch import models
    assert models.ARCH_MODEL_INV_REGISTRY['hifi_gan_mpd'] == [
        'hifi_gan_mpd_base', 'hifi_gan_mpd_small']
    assert models.ARCH_MODEL_INV_REGISTRY['hifi_gan_msd'] == [
        'hifi_gan_msd_base', 'hifi_gan_msd_small']
    x = torch.from_numpy(wav(0, (2, 1, 2048)))
    with torch.no_grad():
        mpd_out = build_model('hifi_gan_mpd_small')(x)
        msd_out = build_model('hifi_gan_msd_small')(x)
    assert len(mpd_out) == 2 and len(msd_out) == 2
    for score, feats in mpd_out:
        assert score.ndim == 2 and score.shape[0] == 2 and len(feats) == 4
    for score, feats in msd_out:
        assert score.shape[0] == 2 and len(feats) == 8
    n_base = sum(p.numel() for arch in ('hifi_gan_mpd_base', 'hifi_gan_msd_base')
                 for p in build_model(arch).parameters())
    assert 80e6 < n_base < 90e6, n_base
