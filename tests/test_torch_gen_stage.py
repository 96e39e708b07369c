"""The port's HiFi-GAN generator stage against the JAX package's fused Pallas
stage (``fused_generator_stage``, interpret mode on the CPU).

The CUDA kernel itself runs only on a card (``chip_smoke.py`` holds it against
the plain version there); here the plain version and the wrapper's CPU
dispatch are held to the reference, at the JAX suite's tolerances (2e-5,
tests/test_pallas.py:187; 2e-4 at C = 256, tests/test_pallas.py:283), and the
wrapper's argument checks are exercised.
"""

import jax

jax.config.update('jax_platforms', 'cpu')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.ops.pallas.gen_stage import fused_generator_stage  # noqa: E402
from pytorch_sound_tpu.ops.pallas.resblock import HALO, stage_plan  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import ResBlock1  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import gen_stage as gs  # noqa: E402

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5),) * 3


def _stage_params(rng, c, k_up, last):
    """Random stage weights shaped as the JAX parameter tree (numpy)."""
    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    up = {'weight': w(2 * c, c, k_up, scale=0.1), 'bias': w(c, scale=0.1)}
    stage = {'resblocks_%d' % j: {
        'convs%d_%d' % (which, r): {'weight': w(c, c, k, scale=1 / np.sqrt(c * k)),
                                    'bias': w(c, scale=0.05)}
        for which in (1, 2) for r in range(3)} for j, k in enumerate(KERNELS)}
    post = {'weight': w(1, c, 7, scale=0.3), 'bias': w(1, scale=0.1)} if last else None
    return up, stage, post


def _pre_params(rng, c, c_mel=80, k=7):
    """conv_pre weights (2C, C_mel, k) shaped as the JAX parameter tree."""
    return {'weight': (rng.standard_normal((2 * c, c_mel, k)) / np.sqrt(c_mel * k))
            .astype(np.float32),
            'bias': (rng.standard_normal(2 * c) * 0.1).astype(np.float32)}


def _torch_args(up, stage, post, u):
    t = torch.from_numpy
    blocks = []
    for j in range(len(KERNELS)):
        convs = []
        for r, d in enumerate(DILATIONS[j]):
            for which, dil in ((1, d), (2, 1)):
                conv = stage['resblocks_%d' % j]['convs%d_%d' % (which, r)]
                convs.append((t(conv['weight']), t(conv['bias']), dil))
        blocks.append(convs)
    return dict(up_weight=t(up['weight']), up_bias=t(up['bias']), blocks=blocks,
                upsample_rate=u,
                conv_post=(t(post['weight']), t(post['bias'])) if post else None)


@pytest.mark.parametrize('c,u,k_up,last,n,t_in,tile_t', [
    (32, 8, 16, False, 2, 20, 4096),     # v2 stage 1 geometry
    (8, 2, 4, True, 2, 300, 4096),       # last stage, conv_post + tanh folded
    (16, 2, 4, False, 1, 2100, 4096),    # output spans two 4096-sample tiles
])
def test_stage_matches_pallas(c, u, k_up, last, n, t_in, tile_t):
    rng = np.random.default_rng(c * 1000 + t_in)
    up, stage, post = _stage_params(rng, c, k_up, last)
    x = rng.standard_normal((n, 2 * c, t_in)).astype(np.float32)
    ref = np.asarray(fused_generator_stage(x, up, stage, c, u, k_up, KERNELS, DILATIONS,
                                           conv_post=post, tile_t=tile_t))
    args = _torch_args(up, stage, post, u)
    out = gs.generator_stage_reference(torch.from_numpy(x), **args).numpy()
    assert out.shape == ref.shape == (n, 1 if last else c, t_in * u)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    # the wrapper runs the plain version for a CPU tensor
    wrapped = gs.generator_stage(torch.from_numpy(x), **args).numpy()
    np.testing.assert_array_equal(wrapped, out)


@pytest.mark.parametrize('c,n,t_in,fold_pre,tol', [
    (128, 2, 12, False, 2e-5),     # v1 stage 1 geometry (u 8, k 16)
    (256, 1, 9, True, 2e-4),       # v1 stage 0 with conv_pre folded in
])
def test_wide_stage_matches_pallas(c, n, t_in, fold_pre, tol):
    """v1's wide stages, which the kernel runs in its cluster layout: the
    plain version and the wrapper's CPU dispatch against the JAX kernel; at C
    = 256 x is the raw mel and conv_pre (80 -> 512, k 7) runs in the stage."""
    rng = np.random.default_rng(c + t_in)
    up, stage, _ = _stage_params(rng, c, 16, False)
    pre = _pre_params(rng, c) if fold_pre else None
    x = rng.standard_normal((n, 80 if fold_pre else 2 * c, t_in)).astype(np.float32)
    ref = np.asarray(fused_generator_stage(x, up, stage, c, 8, 16, KERNELS, DILATIONS,
                                           conv_pre=pre))
    args = _torch_args(up, stage, None, 8)
    if fold_pre:
        args['conv_pre'] = (torch.from_numpy(pre['weight']), torch.from_numpy(pre['bias']))
    out = gs.generator_stage_reference(torch.from_numpy(x), **args).numpy()
    assert out.shape == ref.shape == (n, c, t_in * 8)
    np.testing.assert_allclose(out, ref, atol=tol)
    wrapped = gs.generator_stage(torch.from_numpy(x), **args).numpy()
    np.testing.assert_array_equal(wrapped, out)


def test_plan_and_halo_match_jax():
    """The stage kernel runs each ResBlock1's convs in the order the model
    lists them, which is the JAX kernel's static schedule."""
    assert gs.HALO == HALO
    plan = stage_plan(KERNELS, DILATIONS)
    for j, (k, ds) in enumerate(zip(KERNELS, DILATIONS)):
        convs = ResBlock1(8, k, ds).convs()
        assert [(w.shape[2], d) for w, _, d in convs] == [
            (kk, dd) for b, kk, dd in plan if b == j]


def test_wrapper_raises_off_cpu_and_cuda():
    rng = np.random.default_rng(0)
    args = _torch_args(*_stage_params(rng, 8, 4, False)[:2], None, 2)
    x = torch.zeros((1, 16, 5), device='meta')
    with pytest.raises(RuntimeError, match='cpu or cuda'):
        gs.generator_stage(x, **args)


def test_check_stage_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(1)
    args = _torch_args(*_stage_params(rng, 8, 4, True), 2)
    x = torch.zeros((2, 16, 5))
    gs.check_stage(x, **args)                         # the v2 last stage: accepted
    with pytest.raises(ValueError, match='C <= 64'):     # C = 512, as JAX refuses it
        gs.check_stage(torch.zeros((1, 1024, 3)), **dict(
            args, up_weight=torch.zeros((1024, 512, 16)), up_bias=torch.zeros(512),
            upsample_rate=8))
    with pytest.raises(ValueError, match='2C -> C'):
        gs.check_stage(torch.zeros((2, 15, 5)), **args)
    with pytest.raises(ValueError, match='float32'):
        gs.check_stage(x.double(), **args)
    with pytest.raises(ValueError, match='contiguous'):
        gs.check_stage(torch.zeros((2, 5, 16)).transpose(1, 2), **args)
    long_reach = dict(args, blocks=[[(w, b, 9) for w, b, _ in args['blocks'][2]]])
    with pytest.raises(ValueError, match='halo'):
        gs.check_stage(x, **long_reach)
    with pytest.raises(ValueError, match='blocks'):
        gs.check_stage(x, **dict(args, blocks=args['blocks'] * 3))


@pytest.mark.parametrize('k', [5, 9])
def test_check_stage_takes_hifigan_kernel_sizes_only(k):
    """The kernel is compiled for the resblock kernel sizes of HiFi-GAN v1 and
    v2 (3, 7, 11); any other size is refused before a launch."""
    rng = np.random.default_rng(k)
    args = _torch_args(*_stage_params(rng, 8, 4, False)[:2], None, 2)
    gs.check_stage(torch.zeros((2, 16, 5)), **args)
    odd = dict(args, blocks=[[(torch.zeros((8, 8, k)), b, 1) for _, b, _ in args['blocks'][0]]])
    with pytest.raises(ValueError, match='k in'):
        gs.check_stage(torch.zeros((2, 16, 5)), **odd)


def test_check_stage_takes_wide_widths_and_conv_pre():
    """C = 128 and 256 are accepted (the cluster layout); conv_pre must map
    the mel's channels to the stage's 2C input channels with an odd kernel."""
    rng = np.random.default_rng(3)
    for c in gs.WIDE_CHANNELS:
        up, stage, _ = _stage_params(rng, c, 16, False)
        args = _torch_args(up, stage, None, 8)
        gs.check_stage(torch.zeros((1, 2 * c, 3)), **args)
    pre = (torch.zeros((512, 80, 7)), torch.zeros(512))
    gs.check_stage(torch.zeros((1, 80, 3)), **args, conv_pre=pre)
    with pytest.raises(ValueError, match='conv_pre'):
        gs.check_stage(torch.zeros((1, 81, 3)), **args, conv_pre=pre)
    with pytest.raises(ValueError, match='conv_pre'):
        gs.check_stage(torch.zeros((1, 80, 3)), **args,
                       conv_pre=(torch.zeros((512, 80, 6)), torch.zeros(512)))
    with pytest.raises(ValueError, match='2C -> C'):
        gs.check_stage(torch.zeros((1, 80, 3)), **args,
                       conv_pre=(torch.zeros((256, 80, 7)), torch.zeros(256)))
    with pytest.raises(ValueError, match='C <= 64'):
        wide = _torch_args(*_stage_params(rng, 96, 16, False)[:2], None, 8)
        gs.check_stage(torch.zeros((1, 192, 3)), **wide)
    with pytest.raises(ValueError, match='conv_post folds'):
        gs.check_stage(torch.zeros((1, 512, 3)), **dict(
            args, conv_post=(torch.zeros((1, 256, 7)), torch.zeros(1))))
