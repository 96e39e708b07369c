"""The port's HiFi-GAN interface at full v2 width on the bundled checkpoint,
and at full v1 width on seeded weights, on the CPU, against the JAX package's
interface (flax) and its fused Pallas generator (interpret mode); torch
``.pt`` checkpoints against the JAX converter; and the contract tests of
tests/test_vocoder.py mirrored for the port."""

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.interface.hifi_gan import InterfaceHifiGAN as JaxInterface  # noqa: E402
from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
from pytorch_sound_tpu.models.vocoders.hifi_gan import (  # noqa: E402
    fold_weight_norm_params as jax_fold, generator_apply_fused)
from pytorch_sound_tpu.ops.pallas import gen_stage as jax_gen_stage  # noqa: E402
from pytorch_sound_tpu_torch.interface.hifi_gan import (  # noqa: E402
    AudioParameters, CHECKPOINTS, InterfaceHifiGAN)
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders import hifi_gan as port_hg  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import gen_stage as port_gs  # noqa: E402
from pytorch_sound_tpu_torch.utils.checkpoint import load_msgpack  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)


@pytest.fixture(scope='module')
def iface():
    return InterfaceHifiGAN('hifi_gan_v2', device='cpu')


@pytest.fixture(scope='module')
def jax_iface():
    return JaxInterface('hifi_gan_v2')


def _mel(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2 - 4).astype(np.float32)


def _seeded_tree(shapes, seed):
    """Fill a JAX (g, v) parameter tree of shapes from a seed: each kernel v
    ~ N(0, 1 / fan-in), g its norm (so the folded weight is v), biases ~
    N(0, 0.05); activations stay O(1) through v1's 512-channel stages."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if 'v' in node:
            shape = node['v'].shape
            v = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
            return {'v': v, 'g': np.sqrt(np.sum(v * v, axis=(1, 2), keepdims=True)),
                    'bias': (rng.standard_normal(node['bias'].shape) * 0.05).astype(np.float32)}
        return {k: fill(val) for k, val in node.items()}
    return fill(shapes)


@pytest.fixture(scope='module')
def v1_case():
    """HiFi-GAN v1 at full width: a (g, v) tree shaped by JAX
    ``Generator.init`` (eval_shape, no init compile) and filled from a seed,
    a 2 x 80 x 19 mel, and the flax decode of the folded tree."""
    mel = _mel(19, (2, 80, 19))
    jgen = jax_build_model('hifi_gan_v1')
    tree = _seeded_tree(jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.asarray(mel)), 4)
    folded = jax_fold(tree)
    jgen_folded = jax_build_model('hifi_gan_v1', extra_kwargs={'use_weight_norm': False})
    ref = np.asarray(jgen_folded.apply(folded, jnp.asarray(mel)))
    return tree, folded, jgen_folded, mel, ref


def test_v1_decode_matches_flax(v1_case):
    """v1 through the port's interface (``params=`` a (g, v) tree, folded on
    load): every stage one generator-stage call, conv_pre folded into stage 0."""
    tree, _, _, mel, ref = v1_case
    iface = InterfaceHifiGAN('hifi_gan_v1', params=tree, device='cpu')
    assert iface.decoder.folds_conv_pre(80)
    out = iface.decode(mel).numpy()
    assert out.shape == ref.shape == (2, 1, 19 * 256)
    assert float(np.abs(ref).max()) > 0.05          # the weights drive the output
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_v1_decode_matches_pallas_generator(v1_case):
    """vs the JAX fused path at full v1 width (the wide stage 0 with conv_pre
    folded, interpret mode here)."""
    tree, folded, jgen_folded, mel, _ = v1_case
    ref = np.asarray(generator_apply_fused(jgen_folded, folded, jnp.asarray(mel),
                                           full_stage=True))
    out = InterfaceHifiGAN('hifi_gan_v1', params=tree, device='cpu').decode(mel).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_v1_resblock_route_matches_flax(v1_case):
    """``full_stage=False``: the upsamples by ``F.conv_transpose1d`` and each
    stage's resblock mean by the resblock stage (K3's plain version here)."""
    tree, _, _, mel, ref = v1_case
    gen = build_model('hifi_gan_v1', extra_kwargs={'use_weight_norm': False})
    gen.load_state_dict(port_hg.load_jax_params(tree))
    with torch.no_grad():
        out = port_hg.generator_apply_fused(gen, torch.from_numpy(mel), full_stage=False)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4)


def test_load_jax_params_full_v1_tree(v1_case):
    """The full v1 (g, v) tree of JAX ``Generator.init`` loads strictly into
    the weight-normed generator as it is, and folded into the plain one."""
    tree = v1_case[0]
    wn = build_model('hifi_gan_v1')
    wn.load_state_dict(port_hg.load_jax_params(tree, weight_norm=True))
    plain = build_model('hifi_gan_v1', extra_kwargs={'use_weight_norm': False})
    plain.load_state_dict(port_hg.load_jax_params(tree))
    folded = jax.tree_util.tree_leaves(v1_case[1])
    assert sum(p.numel() for p in plain.parameters()) == sum(a.size for a in folded)
    torch.testing.assert_close(wn.resblocks_0.convs1_0.folded_weight(),
                               plain.resblocks_0.convs1_0.weight, rtol=1e-6, atol=0)


def test_stage_args_fold_conv_pre():
    """v1 folds conv_pre into stage 0 (the JAX rule: ResBlock1, a stage 0
    wider than 128 channels, mel channels <= 128); v2 does not."""
    v1 = build_model('hifi_gan_v1', extra_kwargs={'use_weight_norm': False})
    v2 = build_model('hifi_gan_v2', extra_kwargs={'use_weight_norm': False})
    assert v1.folds_conv_pre(80) and not v1.folds_conv_pre(200)
    assert not v2.folds_conv_pre(80)
    assert v1.stage_args(0)['conv_pre'] is None
    w, b = v1.stage_args(0, fold_conv_pre=True)['conv_pre']
    assert w is v1.conv_pre.weight and b is v1.conv_pre.bias
    for i in (1, 2, 3):
        args = v1.stage_args(i, fold_conv_pre=True)
        assert args['conv_pre'] is None and (args['conv_post'] is not None) == (i == 3)
        assert [len(b) for b in args['blocks']] == [6, 6, 6]
    assert v1.stage_args(0)['up_weight'].shape == (512, 256, 16)


def test_v2_resblock_route_matches_full_stage(iface):
    """The bundled v2 checkpoint: ``full_stage=False`` against the
    full-stage decode on the CPU."""
    mel = torch.from_numpy(_mel(23, (2, 80, 21)))
    with torch.no_grad():
        full = port_hg.generator_apply_fused(iface.decoder, mel)
        split = port_hg.generator_apply_fused(iface.decoder, mel, full_stage=False)
    torch.testing.assert_close(split, full, rtol=0, atol=1e-5)


def test_pt_checkpoint_matches_jax_converter(tmp_path):
    """A narrow v1-shaped torch state dict with weight-norm names
    (``ups.0.weight_g``, ``resblocks.2.convs1.1.weight_v``, ...) under
    'generator': the port's loader gives the JAX converter's tree, and the
    decoded waveforms agree."""
    from pytorch_sound_tpu.interface.hifi_gan import InterfaceHifiGAN as JaxIface
    extra = {'upsample_initial_channel': 32}
    src = port_hg.init_params(build_model('hifi_gan_v1', extra_kwargs=extra),
                              torch.Generator().manual_seed(5))
    state = {}
    for key, val in src.state_dict().items():
        key = key.replace('ups_', 'ups.').replace('resblocks_', 'resblocks.')
        key = key.replace('convs1_', 'convs1.').replace('convs2_', 'convs2.')
        key = key[:-2] + '.weight_v' if key.endswith('.v') else key
        key = key[:-2] + '.weight_g' if key.endswith('.g') else key
        state[key] = val * 7 if key.endswith('weight_v') else val
    assert 'resblocks.2.convs1.1.weight_v' in state and 'ups.0.weight_g' in state
    path = str(tmp_path / 'g.pt')
    torch.save({'generator': state, 'steps': 3}, path)
    tree = InterfaceHifiGAN._load_params(path)
    ref_tree = JaxIface._load_params(path)
    flat = port_hg.load_jax_params(tree)
    ref_flat = port_hg.load_jax_params(ref_tree)
    assert sorted(flat) == sorted(ref_flat)
    for key in flat:
        torch.testing.assert_close(flat[key], ref_flat[key], rtol=0, atol=0)
    mel = _mel(3, (1, 80, 6))
    gen = build_model('hifi_gan_v1', extra_kwargs=dict(extra, use_weight_norm=False))
    gen.load_state_dict(flat)
    with torch.no_grad():
        out = port_hg.generator_apply_fused(gen, torch.from_numpy(mel)).numpy()
    jgen = jax_build_model('hifi_gan_v1', extra_kwargs=dict(extra, use_weight_norm=False))
    ref = np.asarray(jgen.apply(ref_tree, jnp.asarray(mel)))
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize('frames', [13, 32])
def test_decode_matches_jax(iface, jax_iface, frames):
    mel = _mel(frames, (2, 80, frames))
    out = iface.decode(mel).numpy()
    ref = np.asarray(jax_iface.decode(mel))
    assert out.shape == ref.shape == (2, 1, frames * 256)
    np.testing.assert_allclose(out, ref, atol=2e-4)


def _pallas_decode(mel, precision='highest'):
    """JAX's fused generator on the bundled v2 weights (interpret mode)."""
    gen = jax_build_model('hifi_gan_v2', extra_kwargs={'use_weight_norm': False})
    return np.asarray(generator_apply_fused(gen, load_msgpack(CHECKPOINTS['hifi_gan_v2']),
                                            jnp.asarray(mel), precision=precision))


@pytest.fixture(scope='module')
def pallas_decode():
    """A 2 x 80 x 13 mel and JAX's fused 'highest' decode of it."""
    mel = _mel(7, (2, 80, 13))
    return mel, _pallas_decode(mel)


def test_decode_matches_pallas_generator(iface, pallas_decode):
    """vs the JAX fused path the TPU decode runs (every stage one Pallas
    kernel call, interpret mode here)."""
    mel, ref = pallas_decode
    np.testing.assert_allclose(iface.decode(mel).numpy(), ref, atol=2e-4)


# 'default' decode (bf16-rounded operands in every stage) against the fp32
# decode, in waveform units: measured 1.2e-2 here on the bundled v2 weights
DEFAULT_DECODE_TOL = 2 ** -5


# 'bf16x3', the port against JAX in that mode (tests/test_torch_gen_stage.py's
# BF16X3_TOL, BF16X3_RMS_RATIO): each stage and the decode within 4e-5, and
# each stage by RMS at most half as far from JAX as the port's 'highest' is
BF16X3_TOL = 4e-5
BF16X3_RMS_RATIO = 0.5


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


@pytest.mark.parametrize('precision', ['bf16x3', 'default'])
def test_decode_modes_match_pallas_generator(pallas_decode, precision, monkeypatch):
    """The interface's fast modes on the bundled v2 weights against JAX's
    fused generator in the same mode (interpret mode). 'bf16x3' takes the
    JAX kernels' split products: on a 1 x 8-frame mel (the JAX kernel in
    this mode costs ~8 s a stage whatever the length) each of v2's four
    stages (C = 64, 32, 16, 8 with conv_post) is held on its own, fed the
    input JAX's stage took, within BF16X3_TOL and nearer JAX's 'bf16x3'
    than the port's 'highest' is (BF16X3_RMS_RATIO); the decode within
    BF16X3_TOL (over four stages and conv_pre the two packages' sums drift
    apart by RMS 1.3e-6, near the mode's own 1.6e-6 on this waveform).
    'default' is held within DEFAULT_DECODE_TOL of JAX's 'default', which
    XLA computes in fp32 on the CPU (so its 'highest' decode stands in, the
    stage tests check the two equal), and moves the decode off 'highest' by
    its own error (~1e-2)."""
    port = InterfaceHifiGAN('hifi_gan_v2', device='cpu', precision=precision)
    if precision == 'default':
        mel, ref = pallas_decode
        out = port.decode(mel).numpy()
        assert out.shape == ref.shape == (mel.shape[0], 1, mel.shape[2] * 256)
        np.testing.assert_allclose(out, ref, atol=DEFAULT_DECODE_TOL)
        highest = InterfaceHifiGAN('hifi_gan_v2', device='cpu')
        off = float(np.abs(out - highest.decode(mel).numpy()).max())
        assert 1e-3 < off <= DEFAULT_DECODE_TOL, off
        return
    stages = []
    run_stage = jax_gen_stage.fused_generator_stage

    def recorded(x, *args, **kwargs):
        y = run_stage(x, *args, **kwargs)
        stages.append((np.asarray(x), np.asarray(y)))
        return y
    monkeypatch.setattr(jax_gen_stage, 'fused_generator_stage', recorded)
    mel = _mel(11, (1, 80, 8))
    ref = _pallas_decode(mel, precision)
    assert len(stages) == 4
    gen = port.decoder
    with torch.no_grad():
        for i, (x, y) in enumerate(stages):
            x = torch.from_numpy(x.copy())
            got = port_gs.generator_stage(x, **gen.stage_args(i), precision='bf16x3').numpy()
            hi = port_gs.generator_stage(x, **gen.stage_args(i)).numpy()
            np.testing.assert_allclose(got, y, atol=BF16X3_TOL)
            gaps = _rms(got - y), _rms(hi - y)
            assert gaps[0] <= BF16X3_RMS_RATIO * gaps[1], (i, gaps)
    out = port.decode(mel).numpy()
    assert out.shape == ref.shape == (1, 1, 8 * 256)
    np.testing.assert_allclose(out, ref, atol=BF16X3_TOL)


def test_resblock_route_ignores_precision():
    """``full_stage=False`` runs every resblock stage at 'highest' whatever
    the mode, as the JAX route never passes ``precision`` on (and v2's
    conv_pre, outside the stages, is fp32 on both routes)."""
    mel = torch.from_numpy(_mel(5, (1, 80, 6)))
    gen = InterfaceHifiGAN('hifi_gan_v2', device='cpu').decoder
    with torch.no_grad():
        ref = port_hg.generator_apply_fused(gen, mel, full_stage=False)
        for precision in ('bf16x3', 'default'):
            out = port_hg.generator_apply_fused(gen, mel, full_stage=False, precision=precision)
            torch.testing.assert_close(out, ref, rtol=0, atol=0)
        assert not torch.equal(port_hg.generator_apply_fused(gen, mel, precision='default'),
                               port_hg.generator_apply_fused(gen, mel))
    with pytest.raises(ValueError, match='precision'):
        port_hg.generator_apply_fused(gen, mel, full_stage=False, precision='high')


def test_bf16_dtype_decode_matches_jax(iface, jax_iface):
    """``dtype='bfloat16'``: the generator layer by layer in bf16 (as the JAX
    interface runs it on every backend) against JAX's bf16 decode. Both
    round at their own places (PyTorch's CPU bf16 convs, XLA's), so each is
    held against its fp32 decode: the port's error at most 1.5x JAX's, and
    the two bf16 decodes within 2^-3 of each other at most and 2^-8 on
    average, the size of their own errors (measured on this mel: 0.100
    (JAX) and 0.032 (the port) off the fp32 decode at most, 1.2e-3 and
    1.3e-3 on average, and 0.068 / 1.3e-3 apart)."""
    mel = _mel(13, (2, 80, 16))
    port = InterfaceHifiGAN('hifi_gan_v2', device='cpu', dtype='bfloat16')
    assert all(p.dtype == torch.bfloat16 for p in port.decoder.parameters())
    out = port.decode(mel)
    assert out.dtype == torch.float32 and out.shape == (2, 1, 16 * 256)
    ref = np.asarray(JaxInterface('hifi_gan_v2', dtype='bfloat16').decode(mel))
    port_err = float(np.abs(out.numpy() - iface.decode(mel).numpy()).max())
    jax_err = float(np.abs(ref - np.asarray(jax_iface.decode(mel))).max())
    assert 0 < port_err <= 1.5 * jax_err, (port_err, jax_err)
    np.testing.assert_allclose(out.numpy(), ref, atol=2 ** -3)
    assert float(np.abs(out.numpy() - ref).mean()) <= 2 ** -8


def test_encode_matches_jax(iface, jax_iface):
    rng = np.random.default_rng(2)
    wav = (rng.standard_normal((2, 19137)) * 0.2).astype(np.float32)
    out = iface.encode(wav).numpy()
    ref = np.asarray(jax_iface.encode(wav))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_interface_encode_decode_contract(iface):
    sr = AudioParameters.sampling_rate
    t = np.arange(sr) / sr
    wav = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)[None]

    mel = iface.encode(wav)
    assert tuple(mel.shape[0:2]) == (1, 80)
    pad = (AudioParameters.n_fft - AudioParameters.hop_size) // 2
    expected_frames = (sr + 2 * pad - AudioParameters.n_fft) // AudioParameters.hop_size + 1
    assert mel.shape[2] == expected_frames

    out = iface.decode(mel)
    assert out.ndim == 3 and out.shape[1] == 1
    assert out.shape[2] == mel.shape[2] * 256
    assert 0.01 < float(out.abs().max()) <= 1.0

    with pytest.raises(AssertionError):
        iface.encode(wav[0])          # 1D input rejected
    with pytest.raises(AssertionError):
        iface.decode(mel[0])          # 2D input rejected


def test_streaming_decode_matches_full(iface):
    mel = _mel(5, (1, 80, 300))
    full = iface.decode(mel).numpy()
    streamed = iface.decode_streaming(mel, chunk_frames=128, overlap_frames=16).numpy()
    assert streamed.shape == full.shape
    err = np.abs(streamed - full)
    assert float(err[..., 20 * 256: 280 * 256].max()) < 5e-3
    # short input falls through to plain decode
    short = iface.decode_streaming(mel[..., :64], chunk_frames=128).numpy()
    np.testing.assert_allclose(short, iface.decode(mel[..., :64]).numpy(), atol=1e-6)
    # multi-item batch with max_batch smaller than total chunks (6 chunks over
    # two decode calls) reassembles each item correctly
    mel2 = np.concatenate([mel, mel * 0.5], axis=0)
    full2 = iface.decode(mel2).numpy()
    streamed2 = iface.decode_streaming(mel2, chunk_frames=128, overlap_frames=16,
                                       max_batch=4).numpy()
    assert streamed2.shape == full2.shape
    err2 = np.abs(streamed2 - full2)
    assert float(err2[..., 20 * 256: 280 * 256].max()) < 5e-3


def test_streaming_decode_exact_with_zero_pad_edges(iface):
    mel = _mel(17, (1, 80, 300))
    full = iface.decode(mel).numpy()
    streamed = iface.decode_streaming(mel, chunk_frames=128, overlap_frames=32).numpy()
    assert streamed.shape == full.shape
    err = np.abs(streamed - full)
    # the JAX test holds 1e-6; the CPU convolution's summation order depends on
    # the sequence length, which moves single outputs by ~1e-6 (the card's
    # stage kernel matches bit for bit, chip_smoke.py)
    assert float(err[..., 10 * 256:-10 * 256].max()) < 1e-5


def test_encode_decode_cycle_consistency(iface):
    sr = AudioParameters.sampling_rate
    t = np.arange(2 * sr) / sr
    wav = (0.4 * np.sin(2 * np.pi * 220 * t)
           * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)[None]
    mel = iface.encode(wav)
    out = iface.decode(mel)
    mel_cycle = iface.encode(out[:, 0, :])
    n = min(mel.shape[-1], mel_cycle.shape[-1]) - 4
    a = mel[..., 2:n].numpy()
    b = mel_cycle[..., 2:n].numpy()
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert corr > 0.85, corr
    assert float(np.median(np.abs(a - b))) < 2.0


def test_generator_archs_shapes():
    """v1 (ResBlock1, plain stages on the CPU) and v3 (ResBlock2) at a narrow
    width: the registry builds them and the upsampling is 256x."""
    torch.manual_seed(0)
    for arch, frames in (('hifi_gan_v1', 5), ('hifi_gan_v3', 8)):
        gen = build_model(arch, extra_kwargs={'upsample_initial_channel': 32})
        with torch.no_grad():
            out = gen(torch.zeros((1, 80, frames)))
        assert tuple(out.shape) == (1, 1, frames * 256), arch


def test_registry_api():
    """The port's own registry: the JAX registry's names, unknown extra
    kwargs ignored, duplicates refused."""
    from pytorch_sound_tpu.models import ARCH_MODEL_REGISTRY as JAX_ARCHS
    from pytorch_sound_tpu_torch import models
    assert {'hifi_gan_v1', 'hifi_gan_v2', 'hifi_gan_v3'} <= set(JAX_ARCHS)
    assert models.ARCH_MODEL_INV_REGISTRY['hifi_gan'] == [
        'hifi_gan_v1', 'hifi_gan_v2', 'hifi_gan_v3']
    gen = models.build_model('hifi_gan_v2', extra_kwargs={'upsample_initial_channel': 16,
                                                          'no_such_kwarg': 1})
    assert gen.conv_pre.out_channels == 16
    with pytest.raises(ValueError, match='duplicate model'):
        models.register_model('hifi_gan')(torch.nn.Module)
    with pytest.raises(ValueError, match='duplicate model architecture'):
        models.register_model_architecture('hifi_gan', 'hifi_gan_v2')(dict)
    with pytest.raises(ValueError, match='unknown model'):
        models.register_model_architecture('no_such_model', 'x')(dict)


def test_v3_matches_jax_resblock2():
    """ResBlock2 (v3) has no fused kernel in either package: the plain torch
    path matches flax from the same (g, v) parameters."""
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import load_jax_params
    extra = {'upsample_initial_channel': 32}
    jgen = jax_build_model('hifi_gan_v3', extra_kwargs=extra)
    mel = _mel(9, (1, 80, 11))
    # Generator.init's (g, v) tree, shaped by eval_shape (no init compile) and
    # filled from a seed
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
        jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.asarray(mel)))
    ref = np.asarray(jgen.apply(params, jnp.asarray(mel)))
    gen = build_model('hifi_gan_v3', extra_kwargs=dict(extra, use_weight_norm=False))
    gen.load_state_dict(load_jax_params(params))
    with torch.no_grad():
        out = gen(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_construction_guards():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            InterfaceHifiGAN('hifi_gan_v2')            # device defaults to 'cuda'
    with pytest.raises(ValueError, match='precision'):
        InterfaceHifiGAN('hifi_gan_v2', device='cpu', precision='high')
    with pytest.raises(ValueError, match='dtype'):
        InterfaceHifiGAN('hifi_gan_v2', device='cpu', dtype='float16')
    with pytest.raises(AssertionError, match='does not exist'):
        InterfaceHifiGAN('hifi_gan_v1', device='cpu')  # v1 blob is not bundled
    with pytest.raises(AssertionError, match='not valid'):
        InterfaceHifiGAN('hifi_gan_v9', device='cpu')
    with pytest.raises(AssertionError, match='does not exist'):
        InterfaceHifiGAN('hifi_gan_v2', chk_path='model.pt', device='cpu')
