"""The port's resblock stage (K3: the generator-stage kernel with its upsample
off) against the JAX package's fused Pallas resblock stage
(``fused_resblock_stage``, interpret mode on the CPU).

The CUDA kernel runs only on a card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the plain version there); here
the plain version and the wrapper's CPU dispatch are held to the reference at
the JAX suite's tolerance (1e-4, tests/test_pallas.py:127), and the wrapper's
refusals are exercised. K3 takes 'highest' and 'default' (JAX's
``fused_resblock_stage`` modes); 'default' is held as in
tests/test_torch_gen_stage.py.
"""

import functools

import jax

jax.config.update('jax_platforms', 'cpu')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pytorch_sound_tpu.ops.pallas.resblock import fused_resblock_stage  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import ResBlock1  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import gen_stage as gs  # noqa: E402

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5),) * 3


def _blocks(rng, c):
    """Random ResBlock1 weights as the JAX tree and as the wrapper's blocks."""
    tree, blocks = {}, []
    for j, k in enumerate(KERNELS):
        tree['resblocks_%d' % j], convs = {}, []
        for r, d in enumerate(DILATIONS[j]):
            for which, dil in ((1, d), (2, 1)):
                w = (rng.standard_normal((c, c, k)) / np.sqrt(c * k)).astype(np.float32)
                b = (rng.standard_normal(c) * 0.05).astype(np.float32)
                tree['resblocks_%d' % j]['convs%d_%d' % (which, r)] = {'weight': w, 'bias': b}
                convs.append((torch.from_numpy(w), torch.from_numpy(b), dil))
        blocks.append(convs)
    return tree, blocks


CASES = [(64, 2, 300, 256),      # v2 stage 0 width; two Pallas tiles
         (32, 4, 150, 4096)]     # v1 stage 3 width
# 'default' against fp32, relative to the output's max abs: 2^-8 per product
# layer (bf16 on both operands) over a block's 6 convs, rounded up to 2^-5;
# measured up to 1.6e-3
DEFAULT_TOL = 2 ** -5


def _case(c, n, t):
    rng = np.random.default_rng(c + t)
    tree, blocks = _blocks(rng, c)
    return rng.standard_normal((n, c, t)).astype(np.float32), tree, blocks


@functools.lru_cache(maxsize=None)
def _pallas(c, n, t, tile_t, precision):
    """The JAX kernel's output for a case, once per process."""
    x, tree, _ = _case(c, n, t)
    return np.asarray(fused_resblock_stage(x, tree, c, KERNELS, DILATIONS, tile_t=tile_t,
                                           precision=precision))


@pytest.mark.parametrize('c,n,t,tile_t', CASES)
def test_resblock_stage_matches_pallas(c, n, t, tile_t):
    x, _, blocks = _case(c, n, t)
    ref = _pallas(c, n, t, tile_t, 'highest')
    out = gs.resblock_stage_reference(torch.from_numpy(x), blocks).numpy()
    assert out.shape == ref.shape == (n, c, t)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    # the wrapper runs the plain version for a CPU tensor
    wrapped = gs.resblock_stage(torch.from_numpy(x), blocks).numpy()
    np.testing.assert_array_equal(wrapped, out)


@pytest.mark.parametrize('c,n,t,tile_t', CASES)
def test_resblock_stage_default_matches_pallas(c, n, t, tile_t, monkeypatch):
    """'default': within DEFAULT_TOL of the JAX kernel's 'default' (fp32 on
    the CPU, so equal to its 'highest', checked at the v1 width), and bit
    for bit the plain 'highest' stage with every conv's input and weight
    rounded to bf16; 'bf16x3', which the JAX resblock kernel does not take,
    raises."""
    x, _, blocks = _case(c, n, t)
    ref = _pallas(c, n, t, tile_t, 'highest')
    if c == 32:
        np.testing.assert_allclose(_pallas(c, n, t, tile_t, 'default'), ref, atol=1e-4)
    out = gs.resblock_stage(torch.from_numpy(x), blocks, precision='default')
    err = float(np.abs(out.numpy() - ref).max())
    assert 1e-4 * np.abs(ref).max() < err <= DEFAULT_TOL * np.abs(ref).max(), err
    with pytest.raises(ValueError, match='precision'):
        gs.resblock_stage(torch.from_numpy(x), blocks, precision='bf16x3')
    with pytest.raises(ValueError, match='precision'):
        gs.check_resblock_stage(torch.from_numpy(x), blocks, precision='bf16x3')
    monkeypatch.setattr(F, 'conv1d', lambda v, w, *a, _conv=F.conv1d, **kw: _conv(
        v.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(), *a, **kw))
    rounded = gs.resblock_stage_reference(torch.from_numpy(x), blocks)
    torch.testing.assert_close(out, rounded, rtol=0, atol=0)


def test_resblock_stage_is_the_model_resblock_mean():
    """The plain version is the mean of the generator's ResBlock1 modules,
    whose convs() the kernel takes."""
    torch.manual_seed(0)
    mods = [ResBlock1(16, k, d, use_weight_norm=False) for k, d in zip(KERNELS, DILATIONS)]
    x = torch.randn(2, 16, 90)
    with torch.no_grad():
        ref = sum(m(x) for m in mods) / len(mods)
        out = gs.resblock_stage(x, [m.convs() for m in mods])
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


def test_resblock_wrapper_raises_off_cpu_and_cuda():
    _, blocks = _blocks(np.random.default_rng(0), 8)
    with pytest.raises(RuntimeError, match='cpu or cuda'):
        gs.resblock_stage(torch.zeros((1, 8, 5), device='meta'), blocks)


def test_check_resblock_stage_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(1)
    _, blocks = _blocks(rng, 8)
    x = torch.zeros((2, 8, 40))
    gs.check_resblock_stage(x, blocks)
    for c in gs.WIDE_CHANNELS:                 # the cluster layout's widths
        gs.check_resblock_stage(torch.zeros((1, c, 5)), _blocks(rng, c)[1])
    with pytest.raises(ValueError, match='C <= 64'):
        gs.check_resblock_stage(torch.zeros((1, 512, 5)), blocks)
    with pytest.raises(ValueError, match='C <= 64'):
        gs.check_resblock_stage(torch.zeros((1, 12, 5)), blocks)
    with pytest.raises(ValueError, match=r'\(N, C, T\)'):
        gs.check_resblock_stage(torch.zeros((8, 40)), blocks)
    with pytest.raises(ValueError, match='resblock conv'):
        gs.check_resblock_stage(torch.zeros((1, 16, 5)), blocks)
    with pytest.raises(ValueError, match='float32'):
        gs.check_resblock_stage(x.double(), blocks)
    with pytest.raises(ValueError, match='contiguous'):
        gs.check_resblock_stage(torch.zeros((2, 40, 8)).transpose(1, 2), blocks)
    with pytest.raises(ValueError, match='halo'):
        gs.check_resblock_stage(x, [[(w, b, 9) for w, b, _ in blocks[2]]])
    with pytest.raises(ValueError, match='k in'):
        gs.check_resblock_stage(x, [[(torch.zeros((8, 8, 5)), b, 1) for _, b, _ in blocks[0]]])
