"""The port's HiFi-GAN generator stage against the JAX package's fused Pallas
stage (``fused_generator_stage``, interpret mode on the CPU).

The CUDA kernel itself runs only on a card (``chip_smoke.py`` holds it against
the plain version there); here the plain version and the wrapper's CPU
dispatch are held to the reference, at the JAX suite's tolerances (2e-5,
tests/test_pallas.py:187; 2e-4 at C = 256, tests/test_pallas.py:283), and the
wrapper's argument checks are exercised.

The fast modes: 'bf16x3' against the JAX kernel's 'bf16x3' (both sides take
the same split products), within BF16X3_TOL and nearer it than to JAX's
'highest' by BF16X3_RMS_RATIO; 'default' against the
JAX kernel's 'default', which XLA computes in fp32 on the CPU (it equals
'highest' there, checked once), within DEFAULT_TOL, and against the plain
'highest' stage with every conv's operands rounded to bf16, exactly.
"""

import functools

import jax

jax.config.update('jax_platforms', 'cpu')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pytorch_sound_tpu.ops.pallas.gen_stage import fused_generator_stage  # noqa: E402
from pytorch_sound_tpu.ops.pallas.resblock import HALO, stage_plan  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import ResBlock1  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import gen_stage as gs  # noqa: E402

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5),) * 3
# 'default' (bf16-rounded operands) against fp32, relative to the output's
# max abs: bf16's unit roundoff 2^-9 on both operands leaves each product
# within ~2^-8 of its value, and a stage chains 8 product layers (the
# transposed conv, a block's 6 convs, conv_post), so 2^-5; measured up to
# 1.0e-2 on these stages
DEFAULT_TOL = 2 ** -5
# 'bf16x3', the port against the JAX kernel in that mode: their sums differ
# only in order (measured 2.0e-5 at most, on outputs up to 9.6, against the
# mode's own 7.0e-5 off 'highest'); and by RMS at most half the distance
# from JAX's 'bf16x3' to its 'highest' (measured 0.28 and 0.30 here,
# 0.22-0.39 at v2's stages in tests/test_torch_interface.py; ~1.0 for a
# port that ran 'highest' or truncated its split)
BF16X3_TOL = 4e-5
BF16X3_RMS_RATIO = 0.5
NARROW = [(32, 8, 16, False, 2, 20, 4096),     # v2 stage 1 geometry
          (8, 2, 4, True, 2, 300, 4096),       # last stage, conv_post + tanh folded
          (16, 2, 4, False, 1, 2100, 4096)]    # output spans two 4096-sample tiles
WIDE = [(128, 2, 12, False, 2e-5),     # v1 stage 1 geometry (u 8, k 16)
        (256, 1, 9, True, 2e-4)]       # v1 stage 0 with conv_pre folded in


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


def _narrow_case(c, u, k_up, last, n, t_in):
    """A narrow stage's input and weights (numpy) and the wrapper's arguments."""
    rng = np.random.default_rng(c * 1000 + t_in)
    up, stage, post = _stage_params(rng, c, k_up, last)
    x = rng.standard_normal((n, 2 * c, t_in)).astype(np.float32)
    return x, (up, stage, post), _torch_args(up, stage, post, u)


def _wide_case(c, n, t_in, fold_pre):
    """A wide stage's input (the mel with conv_pre folded), weights and the
    wrapper's arguments."""
    rng = np.random.default_rng(c + t_in)
    up, stage, _ = _stage_params(rng, c, 16, False)
    pre = _pre_params(rng, c) if fold_pre else None
    x = rng.standard_normal((n, 80 if fold_pre else 2 * c, t_in)).astype(np.float32)
    args = _torch_args(up, stage, None, 8)
    if fold_pre:
        args['conv_pre'] = (torch.from_numpy(pre['weight']), torch.from_numpy(pre['bias']))
    return x, (up, stage, pre), args


@functools.lru_cache(maxsize=None)
def _pallas(case, precision):
    """The JAX kernel's output for a NARROW or WIDE case, once per process."""
    if len(case) == 7:
        c, u, k_up, last, n, t_in, tile_t = case
        x, (up, stage, post), _ = _narrow_case(c, u, k_up, last, n, t_in)
        return np.asarray(fused_generator_stage(x, up, stage, c, u, k_up, KERNELS, DILATIONS,
                                                conv_post=post, tile_t=tile_t,
                                                precision=precision))
    c, n, t_in, fold_pre, _ = case
    x, (up, stage, pre), _ = _wide_case(c, n, t_in, fold_pre)
    return np.asarray(fused_generator_stage(x, up, stage, c, 8, 16, KERNELS, DILATIONS,
                                            conv_pre=pre, precision=precision))


@pytest.mark.parametrize('c,u,k_up,last,n,t_in,tile_t', NARROW)
def test_stage_matches_pallas(c, u, k_up, last, n, t_in, tile_t):
    x, _, args = _narrow_case(c, u, k_up, last, n, t_in)
    ref = _pallas((c, u, k_up, last, n, t_in, tile_t), 'highest')
    out = gs.generator_stage_reference(torch.from_numpy(x), **args).numpy()
    assert out.shape == ref.shape == (n, 1 if last else c, t_in * u)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    # the wrapper runs the plain version for a CPU tensor
    wrapped = gs.generator_stage(torch.from_numpy(x), **args).numpy()
    np.testing.assert_array_equal(wrapped, out)


@pytest.mark.parametrize('c,n,t_in,fold_pre,tol', WIDE)
def test_wide_stage_matches_pallas(c, n, t_in, fold_pre, tol):
    """v1's wide stages, which the kernel runs in its cluster layout: the
    plain version and the wrapper's CPU dispatch against the JAX kernel; at C
    = 256 x is the raw mel and conv_pre (80 -> 512, k 7) runs in the stage."""
    x, _, args = _wide_case(c, n, t_in, fold_pre)
    ref = _pallas((c, n, t_in, fold_pre, tol), 'highest')
    out = gs.generator_stage_reference(torch.from_numpy(x), **args).numpy()
    assert out.shape == ref.shape == (n, c, t_in * 8)
    np.testing.assert_allclose(out, ref, atol=tol)
    wrapped = gs.generator_stage(torch.from_numpy(x), **args).numpy()
    np.testing.assert_array_equal(wrapped, out)


def _case_args(case):
    """(x, the wrapper's arguments, the JAX tolerance) of a NARROW or WIDE case."""
    if len(case) == 7:
        x, _, args = _narrow_case(*case[:6])
        return x, args, 2e-5
    x, _, args = _wide_case(*case[:4])
    return x, args, case[4]


def _ids(case):
    return 'c%d' % case[0] + ('_pre' if len(case) == 5 and case[3] else '')


def rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


@pytest.mark.parametrize('case', WIDE, ids=_ids)
def test_stage_bf16x3_matches_pallas(case):
    """'bf16x3': the plain version (the three fp32 convs of bf16 hi / lo
    splits) and the wrapper's CPU dispatch against the JAX kernel's
    'bf16x3' at v1's wide stages (C = 128; C = 256 with conv_pre's split,
    which only v1 folds). The JAX kernel costs ~8 s a call in this mode
    whatever the input's length, so v2's narrow stages (C = 64 to 8, and
    conv_post) are held the same way, each on its own, inside the v2 decode
    of tests/test_torch_interface.py."""
    x, args, _ = _case_args(case)
    ref = _pallas(case, 'bf16x3')
    out = gs.generator_stage_reference(torch.from_numpy(x), **args, precision='bf16x3')
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=BF16X3_TOL)
    assert rms(out.numpy() - ref) <= BF16X3_RMS_RATIO * rms(ref - _pallas(case, 'highest'))
    wrapped = gs.generator_stage(torch.from_numpy(x), **args, precision='bf16x3')
    torch.testing.assert_close(wrapped, out, rtol=0, atol=0)


@pytest.mark.parametrize('case', NARROW + WIDE, ids=_ids)
def test_stage_default_matches_pallas(case, monkeypatch):
    """'default': within DEFAULT_TOL of the JAX kernel's 'default', which on
    the CPU is its fp32 'highest' (equal within the stage tolerance, checked
    at the first geometry), and bit for bit the plain 'highest' stage with
    each conv (conv_pre, the transposed conv, the resblock convs, conv_post)
    fed its input and weight rounded to bf16 (nearest even)."""
    x, args, tol = _case_args(case)
    ref = _pallas(case, 'highest')
    if case == NARROW[0]:
        np.testing.assert_allclose(_pallas(case, 'default'), ref, atol=tol)
    out = gs.generator_stage_reference(torch.from_numpy(x), **args, precision='default')
    assert out.shape == ref.shape
    err = float(np.abs(out.numpy() - ref).max())
    assert 1e-4 * np.abs(ref).max() < err <= DEFAULT_TOL * np.abs(ref).max(), err
    wrapped = gs.generator_stage(torch.from_numpy(x), **args, precision='default')
    torch.testing.assert_close(wrapped, out, rtol=0, atol=0)
    for name in ('conv1d', 'conv_transpose1d'):
        conv = getattr(F, name)
        monkeypatch.setattr(F, name, lambda v, w, *a, _conv=conv, **kw: _conv(
            v.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(), *a, **kw))
    rounded = gs.generator_stage_reference(torch.from_numpy(x), **args)
    torch.testing.assert_close(out, rounded, rtol=0, atol=0)


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


def test_unknown_modes_raise():
    """A mode is one of 'highest', 'bf16x3', 'default' (JAX's modes), checked
    before any dispatch, on the CPU as on a card; the wrappers count their
    launches per mode."""
    rng = np.random.default_rng(2)
    args = _torch_args(*_stage_params(rng, 8, 4, True), 2)
    x = torch.zeros((2, 16, 5))
    for precision in gs.MODES:
        gs.check_stage(x, **args, precision=precision)
    for bad in ('high', 'bfloat16', None):
        with pytest.raises(ValueError, match='precision'):
            gs.check_stage(x, **args, precision=bad)
        with pytest.raises(ValueError, match='precision'):
            gs.generator_stage(x, **args, precision=bad)
    assert set(gs.generator_stage.launches_by_mode) == set(gs.MODES)
