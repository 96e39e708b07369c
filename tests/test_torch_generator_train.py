"""The port's weight-normed HiFi-GAN generator (the training form) against
the JAX package's ``Generator`` with ``use_weight_norm=True``, on the CPU;
the weight-norm tree helpers; and the fused inference path against the
layer-by-layer forward."""

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
from pytorch_sound_tpu.models.vocoders import hifi_gan as jax_hg  # noqa: E402
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders import hifi_gan as hg  # noqa: E402

FWD_TOL = 1e-5
GRAD_TOL = 1e-4        # norm of the gradient difference over the gradient's norm


def jax_init_tree(module, mel, seed):
    """The JAX generator's (g, v) tree (shapes from eval_shape) filled from
    a seed: v ~ N(0, 1), g ~ U(0.2, 0.6), small biases."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), mel)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1])
        if "'g'" in name:
            return rng.uniform(0.2, 0.6, s.shape).astype(np.float32)
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


def mel_input(seed, frames):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 80, frames)) * 2 - 4).astype(np.float32)


@pytest.mark.parametrize('arch,extra', [
    ('hifi_gan_v3', {'upsample_initial_channel': 32}),
    ('hifi_gan_v2', {}),
])
def test_weight_norm_generator_matches_jax(arch, extra):
    """Forward within 1e-5 and d(sum(out * r)) / d(every g, v, bias) within
    1e-4 of JAX ``Generator`` with weight norm, from the same (g, v) tree."""
    mel = mel_input(len(arch), 8)
    jgen = jax_build_model(arch, extra_kwargs=extra)
    params = jax_init_tree(jgen, jnp.asarray(mel), seed=7)
    r = np.random.default_rng(1).standard_normal((2, 1, 8 * 256)).astype(np.float32)

    def jax_loss(p):
        out = jgen.apply(p, jnp.asarray(mel))
        return jnp.sum(out * r), out

    (ref_loss, ref_out), ref_grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(params)

    gen = build_model(arch, extra_kwargs=extra)
    assert gen.conv_pre.use_weight_norm
    gen.load_state_dict(hg.load_jax_params(params, weight_norm=True))
    out = gen(torch.from_numpy(mel))
    loss = torch.sum(out * torch.from_numpy(r))
    loss.backward()
    assert tuple(out.shape) == ref_out.shape == (2, 1, 8 * 256)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=FWD_TOL, rtol=0)
    ref_grads = flat(ref_grads['params'])
    grads = {k: p.grad.numpy() for k, p in gen.named_parameters()}
    assert grads.keys() == ref_grads.keys()
    for key, ref in ref_grads.items():
        err = np.linalg.norm(grads[key] - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= GRAD_TOL, (key, err)


def test_weight_norm_tree_round_trip():
    """apply_weight_norm / fold_weight_norm_params invert each other and
    equal the JAX package's tree transforms."""
    jgen = jax_build_model('hifi_gan_v2', extra_kwargs={'use_weight_norm': False,
                                                        'upsample_initial_channel': 32})
    folded = jax_init_tree(jgen, jnp.zeros((1, 80, 8)), seed=3)
    split = hg.apply_weight_norm(folded)
    ref_split = flat(jax.tree_util.tree_map(np.asarray, jax_hg.apply_weight_norm(folded)))
    assert flat(split).keys() == ref_split.keys()
    for key, val in flat(split).items():
        np.testing.assert_allclose(val, ref_split[key], rtol=1e-6, atol=1e-7, err_msg=key)
    back = flat(hg.fold_weight_norm_params(split))
    want = flat(folded)
    assert back.keys() == want.keys()
    for key, val in want.items():
        np.testing.assert_allclose(back[key], val, rtol=1e-5, atol=1e-7, err_msg=key)
    # the weight-normed module computes the same weight as the fold
    gen = build_model('hifi_gan_v2', extra_kwargs={'upsample_initial_channel': 32})
    gen.load_state_dict(hg.load_jax_params(split, weight_norm=True))
    np.testing.assert_allclose(gen.ups_1.folded_weight().detach().numpy(),
                               want['params.ups_1.weight'], rtol=1e-5, atol=1e-7)


def test_fused_path_equals_forward_on_cpu():
    """generator_apply_fused on folded weights (each stage through the
    generator_stage wrapper, its plain version on the CPU) equals the
    layer-by-layer Generator.forward of the weight-normed twin."""
    extra = {'upsample_initial_channel': 64}
    jgen = jax_build_model('hifi_gan_v2', extra_kwargs=extra)
    mel = mel_input(3, 11)
    params = jax_init_tree(jgen, jnp.asarray(mel), seed=4)
    wn = build_model('hifi_gan_v2', extra_kwargs=extra)
    wn.load_state_dict(hg.load_jax_params(params, weight_norm=True))
    folded = build_model('hifi_gan_v2', extra_kwargs=dict(extra, use_weight_norm=False))
    folded.load_state_dict(hg.load_jax_params(params))
    with torch.no_grad():
        out = hg.generator_apply_fused(folded, torch.from_numpy(mel))
        ref = wn(torch.from_numpy(mel))
    assert out.shape == ref.shape == (2, 1, 11 * 256)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_init_params_and_init_weights():
    """init_params draws the JAX init from a generator (v ~ N(0, 0.01),
    g = ||v||, bias 0), the same for the same seed; init_weights re-draws
    only the kernels."""
    a = build_model('hifi_gan_v2', extra_kwargs={'upsample_initial_channel': 32})
    b = build_model('hifi_gan_v2', extra_kwargs={'upsample_initial_channel': 32})
    hg.init_params(a, torch.Generator().manual_seed(5))
    hg.init_params(b, torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    conv = a.resblocks_4.convs1_2
    norm = torch.sqrt(torch.sum(conv.v ** 2, dim=(1, 2), keepdim=True))
    torch.testing.assert_close(conv.g, norm)
    torch.testing.assert_close(conv.folded_weight(), conv.v, rtol=1e-5, atol=1e-8)
    assert float(conv.bias.detach().abs().max()) == 0.0
    v = torch.cat([p.detach().flatten() for n, p in a.named_parameters() if n.endswith('.v')])
    assert abs(float(v.std()) - 0.01) < 5e-4

    g_before = a.conv_pre.g.detach().clone()
    v_before = a.conv_pre.v.detach().clone()
    hg.init_weights(a, torch.Generator().manual_seed(6), std=0.02)
    torch.testing.assert_close(a.conv_pre.g, g_before, rtol=0, atol=0)
    assert not torch.equal(a.conv_pre.v, v_before)
    v = torch.cat([p.detach().flatten() for n, p in a.named_parameters() if n.endswith('.v')])
    assert abs(float(v.std()) - 0.02) < 1e-3
