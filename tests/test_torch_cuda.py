"""The port's CUDA kernels (K1 in both layouts, K3, K2 through K4, the
grouped-conv kernels K6 and the flash-attention kernels K5) against their
plain versions on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. On a
machine with one:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets JAX up, and the port's card
machine needs no JAX.)
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch.ops.cuda import gen_stage as gs

pytestmark = pytest.mark.cuda

STAGE_TOL = 2e-5      # one stage vs plain (tests/test_pallas.py:187)
# of the plain version's max abs, or of a last stage's largest sum of absolute
# conv_post products (chip_smoke.py's MODE_TOL, post_scale)
MODE_TOL = {'bf16x3': 2 ** -16, 'default': 2 ** -7}
# that the kernel ran its mode, rounding to nearest even: nearer the plain
# version of its mode than the plain 'highest' by RMS (chip_smoke.py's
# MODE_RMS_RATIO)
MODE_RMS_RATIO = 0.5


def _ran_mode(out, ref, highest):
    rms = [float(d.double().pow(2).mean().sqrt()) for d in (out - ref, out - highest)]
    assert rms[0] <= MODE_RMS_RATIO * rms[1], rms


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # the plain version in full fp32
    yield torch.device('cuda', 0)
    torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.parametrize('c,u,k_up,post', [
    (64, 8, 16, False),    # v2 stage 0
    (32, 8, 16, False),    # v2 stage 1
    (16, 2, 4, False),     # v2 stage 2
    (8, 2, 4, True),       # v2 stage 3, conv_post + tanh folded
    (64, 2, 4, True),      # a C = 64 last stage: the block sum keeps the conv_post halo
    (24, 2, 4, False),     # a width that is not a power of two
])
def test_stage_kernel_matches_plain(card, c, u, k_up, post):
    """The kernel's entry point picks the widest time tile that fits the
    card's shared memory at each width; the output spans several tiles and a
    ragged last one."""
    rng = np.random.default_rng(c * 10 + u)

    def w(*shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(card)

    blocks = [[(w(c, c, k, scale=1 / np.sqrt(c * k)), w(c, scale=0.05), dil)
               for d in (1, 3, 5) for dil in (d, 1)] for k in gs.KERNEL_SIZES]
    args = dict(up_weight=w(2 * c, c, k_up, scale=0.1), up_bias=w(c, scale=0.1),
                blocks=blocks, upsample_rate=u,
                conv_post=(w(1, c, 7, scale=0.3), w(1, scale=0.1)) if post else None)
    t_in = 4500 // u + 7
    x = w(3, 2 * c, t_in, scale=1.0)
    before = gs.launch_count(gs.generator_stage)
    out = gs.generator_stage(x, **args)
    ref = gs.generator_stage_reference(x, **args)
    assert gs.launch_count(gs.generator_stage) == before + 1
    assert out.shape == ref.shape == (3, 1 if post else c, t_in * u)
    assert float((out - ref).abs().max()) <= STAGE_TOL


def _stage_weights(card, rng, c):
    def w(*shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(card)
    blocks = [[(w(c, c, k, scale=1 / np.sqrt(c * k)), w(c, scale=0.05), dil)
               for d in (1, 3, 5) for dil in (d, 1)] for k in gs.KERNEL_SIZES]
    return w, blocks


@pytest.mark.parametrize('c,pre', [
    (128, False),          # v1 stage 1
    (256, True),           # v1 stage 0, conv_pre folded
    (256, False),
])
def test_wide_stage_kernel_matches_plain(card, c, pre):
    """The cluster layout (C / 32 blocks per tile) over several tiles and a
    ragged last one; relative to the plain version's max abs, as the seeded
    weights set the scale."""
    rng = np.random.default_rng(c + pre)
    w, blocks = _stage_weights(card, rng, c)
    args = dict(up_weight=w(2 * c, c, 16, scale=0.05), up_bias=w(c, scale=0.1),
                blocks=blocks, upsample_rate=8,
                conv_pre=(w(2 * c, 80, 7, scale=0.05), w(2 * c, scale=0.1)) if pre else None)
    x = w(2, 80 if pre else 2 * c, 75, scale=1.0)
    before = (gs.launch_count(gs.generator_stage), gs.generator_stage.wide_launches)
    out = gs.generator_stage(x, **args)
    ref = gs.generator_stage_reference(x, **args)
    assert (gs.launch_count(gs.generator_stage), gs.generator_stage.wide_launches) == (
        before[0] + 1, before[1] + 1)
    assert out.shape == ref.shape == (2, c, 600)
    assert float((out - ref).abs().max()) <= STAGE_TOL * float(ref.abs().max())


@pytest.mark.parametrize('precision', ['bf16x3', 'default'])
@pytest.mark.parametrize('c,pre,post', [(8, False, True), (16, False, False), (24, False, True),
                                        (64, False, False), (128, False, False),
                                        (256, True, False)])
def test_stage_kernel_modes_match_plain(card, c, pre, post, precision):
    """The bf16 modes at each layout (a half chunk at C = 8 and 24, conv_post
    on the narrow last stages, conv_pre folded at C = 256) against the plain
    version of the same mode, over several tiles and a ragged last one,
    and nearer it than the plain 'highest'; one launch counted in that mode;
    K3 in 'default' the same way."""
    rng = np.random.default_rng(c + 7)
    w, blocks = _stage_weights(card, rng, c)
    args = dict(up_weight=w(2 * c, c, 16, scale=0.05), up_bias=w(c, scale=0.1),
                blocks=blocks, upsample_rate=8,
                conv_pre=(w(2 * c, 80, 7, scale=0.05), w(2 * c, scale=0.1)) if pre else None,
                conv_post=(w(1, c, 7, scale=0.3), w(1, scale=0.1)) if post else None)
    x = w(2, 80 if pre else 2 * c, 300 if c <= 64 else 75, scale=1.0)
    before = dict(gs.generator_stage.launches_by_mode)
    out = gs.generator_stage(x, **args, precision=precision)
    ref = gs.generator_stage_reference(x, **args, precision=precision)
    assert gs.generator_stage.launches_by_mode == dict(before, **{
        precision: before[precision] + 1})
    assert out.shape == ref.shape
    scale = float(ref.abs().max())
    if post:
        mean = gs.generator_stage_reference(x, **dict(args, conv_post=None), precision=precision)
        scale = max(scale, float(F.conv1d(F.leaky_relu(mean, 0.01).abs(),
                                          args['conv_post'][0].abs(), padding=3).max()))
    assert float((out - ref).abs().max()) <= MODE_TOL[precision] * scale
    _ran_mode(out, ref, gs.generator_stage_reference(x, **args))
    if precision == 'default':
        h = w(2, c, 1000, scale=1.0)
        res = gs.resblock_stage(h, blocks, precision='default')
        ref = gs.resblock_stage_reference(h, blocks, precision='default')
        assert float((res - ref).abs().max()) <= MODE_TOL[precision] * float(ref.abs().max())
        _ran_mode(res, ref, gs.resblock_stage_reference(h, blocks))


@pytest.mark.parametrize('c,n,t', [(32, 4, 3000), (64, 2, 1500), (128, 2, 700),
                                   (256, 2, 530)])
def test_resblock_kernel_matches_plain(card, c, n, t):
    """K3 (the stage kernel with its upsample off) in both layouts."""
    rng = np.random.default_rng(c + t)
    w, blocks = _stage_weights(card, rng, c)
    x = w(n, c, t, scale=1.0)
    before = gs.launch_count(gs.resblock_stage)
    out = gs.resblock_stage(x, blocks)
    ref = gs.resblock_stage_reference(x, blocks)
    assert gs.launch_count(gs.resblock_stage) == before + 1
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= STAGE_TOL * float(ref.abs().max())


@pytest.mark.parametrize('c,t', [
    (8, 2100),     # one n-tile per warp (the n-tile route of C = 8, 24, 40, 56)
    (16, 2100),    # two n-tiles per warp
    (24, 1100),    # one n-tile, three channel groups of five warps
    (48, 700),     # two n-tiles, three channel groups
    (64, 700),     # four n-tiles, two channel groups
    (256, 773),    # the cluster layout, a ragged last tile of 5 samples
])
def test_resblock_kernel_width_routes(card, c, t):
    """K3 at each n-tile route of the single-block layout and at C = 256
    with a ragged last tile: within STAGE_TOL of the plain version's max
    abs, and bit-identical on a rerun (fixed summation order, no atomics)."""
    rng = np.random.default_rng(c * 7 + t)
    w, blocks = _stage_weights(card, rng, c)
    x = w(1, c, t, scale=1.0)
    out = gs.resblock_stage(x, blocks)
    ref = gs.resblock_stage_reference(x, blocks)
    assert float((out - ref).abs().max()) <= STAGE_TOL * float(ref.abs().max())
    tail = slice(t - 5, t)
    assert float((out[..., tail] - ref[..., tail]).abs().max()) <= \
        STAGE_TOL * float(ref.abs().max())
    assert torch.equal(out, gs.resblock_stage(x, blocks))


@pytest.mark.parametrize('c,pre', [(64, False), (128, False), (256, True)])
def test_stage_kernel_rerun_is_bit_identical(card, c, pre):
    """K1 in the single-block layout and the cluster layout (with conv_pre at
    C = 256), run twice on the same input: the same bits."""
    rng = np.random.default_rng(c + 5)
    w, blocks = _stage_weights(card, rng, c)
    args = dict(up_weight=w(2 * c, c, 16, scale=0.05), up_bias=w(c, scale=0.1),
                blocks=blocks, upsample_rate=8,
                conv_pre=(w(2 * c, 80, 7, scale=0.05), w(2 * c, scale=0.1)) if pre else None)
    x = w(2, 80 if pre else 2 * c, 70, scale=1.0)
    first = gs.generator_stage(x, **args)
    assert torch.equal(first, gs.generator_stage(x, **args))
    ref = gs.generator_stage_reference(x, **args)
    assert float((first - ref).abs().max()) <= STAGE_TOL * float(ref.abs().max())


@pytest.mark.parametrize('c', [64, 256])
def test_stage_kernel_takes_inference_weights(card, c):
    """Weights made under inference mode (which have no version counter) are
    split like any others: the stage kernel gives the same bits as with the
    same weights as ordinary tensors."""
    rng = np.random.default_rng(c + 11)
    w, blocks = _stage_weights(card, rng, c)
    args = dict(up_weight=w(2 * c, c, 16, scale=0.05), up_bias=w(c, scale=0.1),
                blocks=blocks, upsample_rate=8)
    x, h = w(2, 2 * c, 40, scale=1.0), w(2, c, 320, scale=1.0)
    with torch.inference_mode():
        frozen = dict(args, up_weight=args['up_weight'].clone(), blocks=[
            [(wt.clone(), b.clone(), d) for wt, b, d in block] for block in blocks])
        assert frozen['up_weight'].is_inference()
        out = gs.generator_stage(x, **frozen)
        res = gs.resblock_stage(h, frozen['blocks'])
    assert torch.equal(out, gs.generator_stage(x, **args))
    assert torch.equal(res, gs.resblock_stage(h, blocks))


@pytest.mark.parametrize('c', [32, 256])
def test_stage_kernel_sees_writes_through_data(card, c):
    """Weights written through ``.data`` (which leaves their version alone)
    reach the next launch: K1 and K3 match the plain version of the new
    weights, and equal a launch on fresh tensors holding them."""
    rng = np.random.default_rng(c + 23)
    w, blocks = _stage_weights(card, rng, c)
    up_w, up_b = w(2 * c, c, 16, scale=0.05), w(c, scale=0.1)
    x, h = w(2, 2 * c, 40, scale=1.0), w(2, c, 320, scale=1.0)
    gs.generator_stage(x, up_w, up_b, blocks, 8)
    gs.resblock_stage(h, blocks)
    versions = [t._version for t in [up_w] + [wt for block in blocks for wt, _, _ in block]]
    up_w.data.copy_(up_w.data * -0.5)
    for block in blocks:
        for wt, _, _ in block:
            wt.data.copy_(torch.flip(wt.data, dims=[2]))
    assert versions == [t._version for t in [up_w] + [wt for block in blocks
                                                       for wt, _, _ in block]]
    out, res = gs.generator_stage(x, up_w, up_b, blocks, 8), gs.resblock_stage(h, blocks)
    ref = gs.generator_stage_reference(x, up_w, up_b, blocks, 8)
    assert float((out - ref).abs().max()) <= STAGE_TOL * float(ref.abs().max())
    ref = gs.resblock_stage_reference(h, blocks)
    assert float((res - ref).abs().max()) <= STAGE_TOL * float(ref.abs().max())
    fresh = [[(wt.clone(), b, d) for wt, b, d in block] for block in blocks]
    assert torch.equal(out, gs.generator_stage(x, up_w.clone(), up_b, fresh, 8))
    assert torch.equal(res, gs.resblock_stage(h, fresh))


MEL_TOL = 1e-4        # log-mel kernel vs plain (tests/test_pallas.py:98)


@pytest.mark.parametrize('t', [1, 2, 255, 256, 383, 384, 385])
def test_log_mel_kernel_short_inputs(card, t):
    """Inputs the reflect pad exceeds, by numpy's rule: K2 in both
    conventions and K4's backward against the plain version in fp64 (shape
    (3, 80, 0) below one frame, with no launch and a zero gradient), reruns
    bit-identical."""
    from pytorch_sound_tpu_torch.ops import mel as mel_ops
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    rng = np.random.default_rng(t)
    x = torch.from_numpy((rng.standard_normal((3, t)) * 0.2).astype(np.float32)).to(card)
    filt = mel_ops.cached_mel_filter(22050, 1024, 80, 0.0, 8000.0)
    for pad, kw in ((384, dict(power_eps=1e-9, log_floor=1e-5)), (512, {})):
        before = lm.fused_log_mel.launches
        got = lm.fused_log_mel(x, mel_max=8000.0, pad=pad, **kw)
        frames = mel_ops.n_frames(t, 1024, 256, pad)
        assert lm.fused_log_mel.launches == before + (frames > 0)
        ref = mel_ops.log_mel(x.double(), filt, 1024, 256, 1024, pad, **kw)
        assert got.shape == ref.shape == (3, 80, frames)
        assert got.numel() == 0 or float((got.double() - ref).abs().max()) <= MEL_TOL
        assert torch.equal(got, lm.fused_log_mel(x, mel_max=8000.0, pad=pad, **kw))
    mel = lm.fused_hifigan_mel(x)
    cot = torch.cos(mel)
    before = lm.fused_hifigan_mel_trainable.bwd_launches
    got = lm.hifigan_mel_backward(x, cot)
    assert lm.fused_hifigan_mel_trainable.bwd_launches == before + (mel.numel() > 0)
    ref = lm.hifigan_mel_vjp(x.double(), cot.double())
    assert float((got.double() - ref).abs().max()) <= 1e-6 * max(float(ref.abs().max()), 1.0)
    assert torch.equal(got, lm.hifigan_mel_backward(x, cot))


def _tones(rng, b, t):
    n = np.arange(t) / 22050
    return np.stack([sum(0.4 / h * np.sin(2 * np.pi * rng.uniform(90, 300) * h * n)
                         for h in range(1, 6)) for _ in range(b)]).astype(np.float32)


@pytest.mark.parametrize('n_fft,t,conv', [
    (1024, 66150, 'hifigan'), (1024, 50001, 'centered'), (1024, 20000, 'centered_all_bins'),
    (1024, 640, 'hifigan'), (1024, 385, 'hifigan'), (512, 30000, 'hifigan'),
    (2048, 30000, 'centered'), (256, 9000, 'centered'), (4096, 30000, 'hifigan'),
    (400, 30000, 'centered'), (1000, 30000, 'hifigan'), (128, 5000, 'centered_all_bins'),
    (8192, 60000, 'hifigan'), (300, 301, 'centered'), (375, 30000, 'hifigan'),
    (6000, 30000, 'centered'), (750, 9000, 'centered_all_bins'), (802, 30000, 'hifigan'),
    (22, 3000, 'centered_all_bins')])
def test_log_mel_kernel_matches_plain(card, n_fft, t, conv):
    """K2 against the plain version run in fp64 on the same card tensor:
    noise and tones, both conventions, every bin to fmax None, short inputs
    (t = 640 and t = pad + 1 at the HiFi-GAN pad 384), the n_fft of the
    in-block mixed-radix FFT (power-of-two and 7-smooth halves, odd 375) and
    those of the direct DFT (802, 22), each launch counted on its path."""
    from pytorch_sound_tpu_torch.ops import mel as mel_ops
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    rng = np.random.default_rng(n_fft + t)
    hop = next(n_fft // d for d in (4, 3, 2) if n_fft % d == 0)
    fmax = None if conv == 'centered_all_bins' else 8000.0
    pad = (n_fft - hop) // 2 if conv == 'hifigan' else n_fft // 2
    kw = dict(power_eps=1e-9, log_floor=1e-5) if conv == 'hifigan' else {}
    filt = mel_ops.cached_mel_filter(22050, n_fft, 80, 0.0, fmax)
    for wav in (rng.standard_normal((3, t)) * 0.2, _tones(rng, 3, t)):
        x = torch.from_numpy(wav.astype(np.float32)).to(card)
        before = (lm.fused_log_mel.launches, lm.fused_log_mel.direct_launches)
        got = lm.fused_log_mel(x, n_fft=n_fft, win_length=n_fft, hop_length=hop,
                               mel_max=fmax, pad=pad, **kw)
        assert (lm.fused_log_mel.launches, lm.fused_log_mel.direct_launches) == (
            before[0] + 1, before[1] + (not lm.fft_path(n_fft)))
        ref = mel_ops.log_mel(x.double(), filt, n_fft, hop, n_fft, pad, **kw)
        assert got.shape == ref.shape
        assert float((got.double() - ref).abs().max()) <= MEL_TOL


def test_log_mel_kernel_batch_equals_items(card):
    """Each frame is computed alone: a batch's log-mel equals its items'
    log-mels bit for bit, and a rerun equals the first run."""
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    x = torch.from_numpy(_tones(np.random.default_rng(3), 16, 44100)).to(card)
    batch = lm.fused_hifigan_mel(x)
    assert torch.equal(batch, lm.fused_hifigan_mel(x))
    for i in range(16):
        assert torch.equal(batch[i:i + 1], lm.fused_hifigan_mel(x[i:i + 1].contiguous()))


def test_kernel_rejects_unsupported_n_fft(card):
    """The kernel takes the JAX kernel's geometry, hop | n_fft and win ==
    n_fft, and raises on the others (no plain route on the card)."""
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    x = torch.zeros((1, 9000), device=card)
    for n_fft, hop, win in ((1024, 384, 1024), (1000, 250, 800)):
        with pytest.raises(ValueError, match='geometry'):
            lm.fused_log_mel(x, n_fft=n_fft, win_length=win, hop_length=hop)


@pytest.mark.parametrize('n_fft,hop', [(1024, 256), (400, 100)])
def test_log_mel_transform_raises_on_grad_and_dtype(card, n_fft, hop):
    """LogMelSpectrogram (and MFCC through it) on the card, on both kernel
    paths: the kernel has no gradient, so an input that requires one while
    autograd records raises, as does float64 input, where the CPU runs the
    plain version; under no_grad the same input launches the kernel."""
    from pytorch_sound_tpu_torch.models import transforms as T
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    x = torch.from_numpy(_tones(np.random.default_rng(5), 2, 8000)).to(card)
    lms = T.LogMelSpectrogram(22050, 80, n_fft, n_fft, hop, -50, 30, 0, 8000)
    mfcc = T.MFCC(22050, 80, n_fft, n_fft, 20, hop, -50, 30, 0, 8000)
    w = x.clone().requires_grad_(True)
    for fn, arg in ((lms, w), (mfcc, w[:, None])):
        with pytest.raises(RuntimeError, match='no gradient'):
            fn(arg)
    with pytest.raises(ValueError, match='float32'):
        lms(x.double())
    assert lms(w.cpu()).grad_fn is not None
    before = lm.fused_log_mel.launches
    with torch.no_grad():
        got = lms(w)
    assert lm.fused_log_mel.launches == before + 1 and torch.equal(got, lms(x))


def test_trainable_mel_kernel_matches_plain(card):
    """K4 at the training shape (16 x 8192): the forward launches the log-mel
    kernel once and matches the plain version; the backward launches its
    kernels once, matches autograd of the plain version on white noise
    (fp32) and, relative to its largest entry, autograd in fp64 on tones;
    a rerun of the backward is bit-identical."""
    from pytorch_sound_tpu_torch.ops import mel as mel_ops
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    rng = np.random.default_rng(12)
    wav = torch.from_numpy((rng.standard_normal((16, 8192)) * 0.2).astype(np.float32)).to(card)
    grads = []
    for fn in (lm.fused_hifigan_mel_trainable, mel_ops.hifigan_mel_spectrogram):
        w = wav.clone().requires_grad_(True)
        before = (lm.fused_log_mel.launches, lm.fused_hifigan_mel_trainable.launches,
                  lm.fused_hifigan_mel_trainable.bwd_launches)
        mel = fn(w)
        torch.sum(torch.sin(mel)).backward()
        grads.append((mel.detach(), w.grad))
        if fn is lm.fused_hifigan_mel_trainable:
            assert (lm.fused_log_mel.launches, lm.fused_hifigan_mel_trainable.launches,
                    lm.fused_hifigan_mel_trainable.bwd_launches) == (
                before[0] + 1, before[1] + 1, before[2] + 1)
    (mel_k, g_k), (mel_p, g_p) = grads
    assert mel_k.shape == (16, 80, 32)
    assert float((mel_k - mel_p).abs().max()) <= 1e-4
    assert float((g_k - g_p).abs().max()) <= 1e-4
    assert torch.equal(g_k, lm.hifigan_mel_backward(wav, torch.cos(mel_k)))

    tonal = torch.from_numpy(_tones(rng, 4, 8192)).to(card)
    mel = lm.fused_hifigan_mel(tonal)
    cot = torch.cos(mel)
    got = lm.hifigan_mel_backward(tonal, cot)
    ref = lm.hifigan_mel_vjp(tonal.double(), cot.double())
    assert float((got.double() - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.parametrize('sr,n_fft,hop,route', [
    (16000, 400, 100, 'auto'), (22050, 1000, 250, 'auto'), (16000, 375, 125, 'auto'),
    (22050, 750, 250, 'auto'), (16000, 802, 401, 'auto'), (16000, 400, 100, 'direct')])
def test_direct_backward_matches_plain(card, sr, n_fft, hop, route):
    """K4's backward off the HiFi-GAN geometry, on the mixed-radix FFT (400,
    1000, odd 375, and 750, whose odd P = 375 pairs every C[k] with C[P - k]
    and has no middle bin) and on the direct DFT (802, and 400 through
    ``_direct_backward``): one launch, autograd of the fp32 plain version
    and fp64 autograd, each relative to its largest entry (at 16 kHz the
    gradient reaches ~30, and the fp32 plain version is ~2e-4 off fp64
    there), a bit-identical rerun; the forward on either path within 1e-5
    of the other."""
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    rng = np.random.default_rng(n_fft)
    wav = torch.from_numpy((rng.standard_normal((4, 3 * sr)) * 0.2).astype(np.float32)).to(card)
    kw = dict(sampling_rate=sr, n_fft=n_fft, window_size=n_fft, hop_size=hop, num_mels=80,
              fmax=8000.0)
    forward, other, backward = (
        (lm.fused_log_mel, lm._direct_log_mel, lm.hifigan_mel_backward) if route == 'auto'
        else (lm._direct_log_mel, lm.fused_log_mel, lm._direct_backward))
    mel_kw = dict(mel_max=8000.0, pad=(n_fft - hop) // 2, power_eps=1e-9, log_floor=1e-5)
    mel = forward(wav, sr, 80, n_fft, n_fft, hop, **mel_kw)
    assert float((mel - other(wav, sr, 80, n_fft, n_fft, hop, **mel_kw)).abs().max()) <= 1e-5
    cot = torch.cos(mel)
    before = lm.fused_hifigan_mel_trainable.bwd_launches
    got = backward(wav, cot, **kw)
    assert lm.fused_hifigan_mel_trainable.bwd_launches == before + 1
    plain = lm.hifigan_mel_vjp(wav, cot, **kw)
    assert float((got - plain).abs().max()) <= 1e-4 * float(plain.abs().max())
    ref = lm.hifigan_mel_vjp(wav.double(), cot.double(), **kw)
    assert float((got.double() - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert torch.equal(got, backward(wav, cot, **kw))


GC_FWD_TOL = 1e-5     # max abs error over the plain version's max abs
GC_GRAD_TOL = 1e-4    # the same ratio for dx and dw (dw sums N x T_out terms)


@pytest.mark.parametrize('n,ci,co,k,s,g,p,t', [
    (4, 1, 128, 15, 1, 1, 7, 8192),       # MSD L0: one input channel
    (4, 128, 128, 41, 2, 4, 20, 8192),    # MSD L1
    (4, 256, 512, 41, 4, 8, 20, 2049),    # MSD L3 at scale 2, odd length
    (4, 1024, 1024, 41, 1, 8, 20, 129),   # MSD L5
    (4, 1024, 1024, 5, 1, 1, 2, 129),     # MSD L6 (dense k5)
    (4, 1024, 1, 3, 1, 1, 1, 129),        # conv_post: one output channel
    (44, 1, 32, 5, 3, 1, 2, 745),         # MPD L0 at period 11
    (44, 512, 1024, 5, 3, 1, 2, 28),      # MPD L3 at period 11
])
def test_grouped_conv_kernels_match_plain(card, n, ci, co, k, s, g, p, t):
    """The three grouped-conv kernels (forward with bias and slope, dx, dw)
    against their plain versions at critic geometries; dw is bit-identical
    on a rerun."""
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    rng = np.random.default_rng(n + ci + co + k + t)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(card)

    x, w, b = arr(n, ci, t), arr(co, ci // g, k, scale=(ci // g * k) ** -0.5), arr(co)
    conf = dict(stride=s, padding=p, groups=g)
    before = (gc.conv1d_forward.launches, gc.conv1d_input_grad.launches,
              gc.conv1d_weight_grad.launches)
    y = gc.conv1d_forward(x, w, b, slope=0.1, **conf)
    y_ref = gc.grouped_conv1d_reference(x, w, b, slope=0.1, **conf)
    gy = arr(*y_ref.shape)
    dx = gc.conv1d_input_grad(gy, w, t, **conf)
    dx_ref = gc.conv1d_input_grad_reference(gy, w, t, **conf)
    dw = gc.conv1d_weight_grad(x, gy, w.shape, **conf)
    dw_ref = gc.conv1d_weight_grad_reference(x, gy, w.shape, **conf)
    assert torch.equal(dw, gc.conv1d_weight_grad(x, gy, w.shape, **conf))
    assert (gc.conv1d_forward.launches, gc.conv1d_input_grad.launches,
            gc.conv1d_weight_grad.launches) == (before[0] + 1, before[1] + 1, before[2] + 2)
    for got, ref, tol in ((y, y_ref, GC_FWD_TOL), (dx, dx_ref, GC_GRAD_TOL),
                          (dw, dw_ref, GC_GRAD_TOL)):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol


def test_conv_transpose_kernel_matches_plain(card):
    """ConvTranspose1d (the dx kernel of the mirror conv) forward and its
    backward (forward and dw kernels) at v2's first upsample, 16 x 32 frames."""
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    rng = np.random.default_rng(21)
    x0, w0, b0 = (torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32)).to(card)
                  for s in ((16, 128, 32), (128, 64, 16), (64,)))
    outs = []
    for fn in (gc.conv_transpose1d, gc.conv_transpose1d_reference):
        x, w, b = (a.clone().requires_grad_(True) for a in (x0, w0, b0))
        y = fn(x, w, b, stride=8, padding=4)
        torch.sin(y).sum().backward()
        outs.append((y.detach(), x.grad, w.grad, b.grad))
    for got, ref in zip(*outs):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max() / ref.abs().max()) <= GC_GRAD_TOL


def _bf16_ulp(scale):
    """One bf16 ulp at the binade of ``scale`` (7 stored mantissa bits)."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def _hold_mode(got, ref, highest, tol):
    """A K6 kernel in precision 'default' (float32 tensors) or on bfloat16
    tensors against the plain version of its mode: within ``tol`` of the
    plain version's max abs (the same rounded operands, exact products: only
    the sums' order differs), plus one bf16 ulp of that scale for a bf16
    output (both round once, and may round apart); and nearer it than the
    plain 'highest' of the float32 operands by RMS (_ran_mode)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype)
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    limit = tol * scale + (_bf16_ulp(scale) if bf16 else 0.0)
    err = float((got - ref).abs().max())
    assert err <= limit, (err, limit)
    _ran_mode(got, ref, highest.float())


@pytest.mark.parametrize('route', ['default', 'bf16'])
@pytest.mark.parametrize('n,ci,co,k,s,g,dil,p,t,misaligned', [
    (4, 1, 128, 15, 1, 1, 1, 7, 2048, False),       # MSD L0: fwd / dx on the CUDA cores
    (4, 128, 128, 41, 2, 4, 1, 20, 2048, False),    # MSD L1
    (4, 256, 512, 41, 4, 8, 1, 20, 2049, False),    # MSD L3 at scale 2, odd length
    (4, 1024, 1024, 41, 1, 8, 1, 20, 33, False),    # MSD L5 at scale 2: t_out 33, gy padded
    (4, 1024, 1, 3, 1, 1, 1, 1, 129, False),        # conv_post: one output channel
    (44, 1, 32, 5, 3, 1, 1, 2, 745, False),         # MPD L0 at period 11
    (352, 512, 1024, 5, 3, 1, 1, 2, 28, False),     # MPD L3 at period 11: t_out 10
    (2, 17, 17, 5, 1, 1, 1, 2, 1001, False),        # 17 rows: ragged tiles
    (2, 8, 8, 5, 1, 1, 1, 2, 1000, False),          # 8 rows: every entry on the CUDA cores
    (2, 7, 17, 5, 1, 1, 1, 2, 301, False),          # cg k = 35: w packed
    (3, 32, 64, 7, 2, 2, 3, 9, 500, False),         # stride 2, dilation 3
    (2, 64, 64, 41, 2, 4, 1, 20, 1000, True),       # every tensor one element off alignment
])
def test_grouped_conv_modes_match_plain(card, route, n, ci, co, k, s, g, dil, p, t,
                                        misaligned):
    """The three K6 entry points in precision 'default' on float32 tensors
    and on bfloat16 tensors (the bf16 route) against the plain version of
    the mode: forward with bias and slope, dx plain and with bias and slope,
    dw; each launch counted under its route; dw rerun bit-identical."""
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    rng = np.random.default_rng(n * ci + co + k + t + s)
    dtype = torch.bfloat16 if route == 'bf16' else torch.float32

    def arr(*shape, scale=1.0):
        a = torch.from_numpy((rng.standard_normal(shape) * scale)
                             .astype(np.float32)).to(card)
        return a, aligned_off(a.to(dtype))

    def aligned_off(a):
        if misaligned:          # a contiguous view one element into its storage
            a = torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(a.shape)
            assert a.data_ptr() % 8 != 0
        return a

    conf = dict(stride=s, padding=p, groups=g, dilation=dil)
    t_out = gc.conv_out_len(t, k, s, p, dil)
    (x32, x), (w32, w) = arr(n, ci, t), arr(co, ci // g, k, scale=(ci // g * k) ** -0.5)
    (gy32, gy) = arr(n, co, t_out)
    b_out, b_in = arr(co)[0], arr(ci)[0]
    counters = (gc.conv1d_forward, gc.conv1d_input_grad, gc.conv1d_weight_grad)
    before = [dict(c.launches_by_mode) for c in counters]
    kw = dict(conf, precision='default')
    y = gc.conv1d_forward(x, w, b_out, slope=0.1, **kw)
    dx = gc.conv1d_input_grad(gy, w, t, **kw)
    dxb = gc.conv1d_input_grad(gy, w, t, b_in, slope=0.2, **kw)
    dw = gc.conv1d_weight_grad(x, gy, w.shape, **kw)
    assert torch.equal(dw, gc.conv1d_weight_grad(x, gy, w.shape, **kw))
    for c, b, calls in zip(counters, before, (1, 2, 2)):
        assert c.launches_by_mode == dict(b, **{route: b[route] + calls}), c.__name__
    y_ref = gc.grouped_conv1d_reference(x, w, b_out, slope=0.1, **kw)
    dx_ref = gc.conv1d_input_grad_reference(gy, w, t, **kw)
    dxb_ref = F.leaky_relu(gc.conv1d_input_grad_reference(gy.float(), w.float(), t, **kw)
                           + b_in[None, :, None], 0.2).to(dtype)
    dw_ref = gc.conv1d_weight_grad_reference(x, gy, w.shape, **kw)
    y_hi = gc.grouped_conv1d_reference(x32, w32, b_out, slope=0.1, **conf)
    dx_hi = gc.conv1d_input_grad_reference(gy32, w32, t, **conf)
    dxb_hi = F.leaky_relu(dx_hi + b_in[None, :, None], 0.2)
    dw_hi = gc.conv1d_weight_grad_reference(x32, gy32, w.shape, **conf)
    for got, ref, hi, tol in ((y, y_ref, y_hi, GC_FWD_TOL), (dx, dx_ref, dx_hi, GC_GRAD_TOL),
                              (dxb, dxb_ref, dxb_hi, GC_GRAD_TOL),
                              (dw, dw_ref, dw_hi, GC_GRAD_TOL)):
        _hold_mode(got, ref, hi, tol)


def test_grouped_conv_bf16_autograd(card):
    """grouped_conv1d on bfloat16 activations and a bf16 copy of an fp32
    master weight (the critics' compute_dtype='bf16'): bf16 output and input
    gradient, fp32 weight and bias gradients, each equal to the plain
    version's chain of the same rounded operands."""
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    rng = np.random.default_rng(31)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(card)

    conf = dict(stride=2, padding=20, groups=4)
    x = arr(4, 128, 2048).to(torch.bfloat16).requires_grad_(True)
    w32 = arr(128, 32, 41, scale=(32 * 41) ** -0.5).requires_grad_(True)
    b = arr(128).requires_grad_(True)
    r = arr(4, 128, 1024)
    y = gc.grouped_conv1d(x, w32.to(torch.bfloat16), b, slope=0.1, precision='highest', **conf)
    assert y.dtype == torch.bfloat16
    (y.float() * r).sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w32.grad.dtype == b.grad.dtype == torch.float32
    with torch.no_grad():
        w = w32.to(torch.bfloat16)
        g = r.to(torch.bfloat16)
        g = torch.where(y > 0, g, g * 0.1)
        kw = dict(conf, precision='default')
        y_ref = gc.grouped_conv1d_reference(x, w, b, slope=0.1, **kw)
        dx_ref = gc.conv1d_input_grad_reference(g, w, 2048, **kw)
        dw_ref = gc.conv1d_weight_grad_reference(x, g, w.shape, **kw).float()
        db_ref = g.float().sum(dim=(0, 2))
    _hold_mode(y, y_ref, gc.grouped_conv1d_reference(x.float(), w32, b, slope=0.1, **conf),
               GC_FWD_TOL)
    _hold_mode(x.grad, dx_ref, gc.conv1d_input_grad_reference(r, w32, 2048, **conf),
               GC_GRAD_TOL)
    assert float((w32.grad - dw_ref).abs().max()) <= \
        GC_GRAD_TOL * float(dw_ref.abs().max()) + _bf16_ulp(float(dw_ref.abs().max()))
    assert float((b.grad - db_ref).abs().max()) <= 1e-5 * float(db_ref.abs().max())


FLASH_FWD_TOL = 1e-5    # max abs error over the plain version's max abs
FLASH_GRAD_TOL = 1e-4   # the same ratio for dq, dk and dv


@pytest.mark.parametrize('n,h,tq,tk,d,masked', [
    (2, 2, 77, 77, 16, True),       # tests/test_attention.py's ragged masked case
    (1, 2, 96, 96, 160, False),     # D = 160: 32-key tiles in the backward
    (2, 3, 130, 200, 64, True),     # Tq != Tk, ragged tiles on both axes
    (1, 1, 65, 33, 256, True),      # the widest head
    (2, 4, 300, 300, 32, False),
    (2, 8, 1000, 1000, 64, True),   # several query and key tiles per block
])
def test_flash_attention_kernels_match_plain(card, n, h, tq, tk, d, masked):
    """The forward (o and lse), dK / dV and dQ kernels against their plain
    versions, every item keeping at least one valid key; then the autograd
    function's gradients against autograd of the plain forward."""
    from pytorch_sound_tpu_torch.ops.cuda import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(n * h + tq + d)
    q, k, v = (torch.randn((n, h, t, d), generator=g, device=card) for t in (tq, tk, tk))
    kv = None
    if masked:
        lens = torch.tensor([tk - 13 * i for i in range(n)], device=card)
        kv = (torch.arange(tk, device=card)[None] < lens[:, None]).float()
    before = (fa.attention_forward.launches, fa.attention_dkv.launches, fa.attention_dq.launches)
    o, lse = fa.attention_forward(q, k, v, kv)
    o_ref, lse_ref = fa.attention_reference(q, k, v, kv)
    dout = torch.randn(o.shape, generator=g, device=card)
    di = (o_ref * dout).sum(dim=-1)
    dk, dv = fa.attention_dkv(q, k, v, kv, dout, lse_ref, di)
    dq = fa.attention_dq(q, k, v, kv, dout, lse_ref, di)
    refs = (fa.attention_dq_reference(q, k, v, kv, dout, lse_ref, di),
            *fa.attention_dkv_reference(q, k, v, kv, dout, lse_ref, di))
    assert (fa.attention_forward.launches, fa.attention_dkv.launches,
            fa.attention_dq.launches) == (before[0] + 1, before[1] + 1, before[2] + 1)
    for got, ref, tol in ((o, o_ref, FLASH_FWD_TOL), (lse, lse_ref, FLASH_FWD_TOL),
                          (dq, refs[0], FLASH_GRAD_TOL), (dk, refs[1], FLASH_GRAD_TOL),
                          (dv, refs[2], FLASH_GRAD_TOL)):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol

    grads = []
    for fn in (fa.flash_attention_trainable, lambda *a: fa.attention_reference(*a)[0]):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves, kv) * dout).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        assert float((got - ref).abs().max() / ref.abs().max()) <= FLASH_GRAD_TOL


def test_mha_blockwise_route_runs_the_kernels(card):
    """MultiHeadAttention at a width of 128 / 4 heads, T = 600, blockwise
    (the kernels) against its dense route: output, input gradient and the
    qkv projection's gradient."""
    from pytorch_sound_tpu_torch.models.modules import MultiHeadAttention
    from pytorch_sound_tpu_torch.ops.cuda import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    dense = MultiHeadAttention(128, 4, block_size=-1).to(card)
    blocky = MultiHeadAttention(128, 4, auto_threshold=512).to(card)
    blocky.load_state_dict(dense.state_dict())
    x0 = torch.randn(3, 128, 600, device=card)
    # a random cotangent: sum(out ** 2) is constant through the LayerNorm,
    # so its input gradient would be rounding noise
    w = torch.randn(3, 128, 600, device=card)
    mask = torch.arange(600, device=card)[None] >= torch.tensor([[600], [480], [321]], device=card)
    outs = []
    before = (fa.attention_forward.launches, fa.attention_dkv.launches, fa.attention_dq.launches)
    for m in (blocky, dense):
        x = x0.clone().requires_grad_(True)
        out, _ = m(x, mask)
        (out * w).sum().backward()
        outs.append((out.detach(), x.grad, m.linear_kvq.weight.grad))
    assert (fa.attention_forward.launches, fa.attention_dkv.launches,
            fa.attention_dq.launches) == (before[0] + 1, before[1] + 1, before[2] + 1)
    for got, ref in zip(*outs):
        assert float((got - ref).abs().max() / ref.abs().max()) <= FLASH_GRAD_TOL


def test_flash_fully_masked_item_matches_the_scan(card):
    """An item whose keys are all masked: the forward kernel gives the mean of
    v over its Tk keys, as the plain version and the plain scan do (the scan
    pads its last key block, t = 100 at block 64). The backward kernels skip
    no key tile of that item (p = 1 on every key) and match their plain
    versions there and on the half-masked item, whose masked keys' dK / dV
    are exactly 0."""
    from pytorch_sound_tpu_torch.ops.attention import blockwise_attention
    from pytorch_sound_tpu_torch.ops.cuda import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn((2, 3, 100, 64), generator=g, device=card) for _ in range(3))
    mask = torch.zeros((2, 100), dtype=torch.bool, device=card)
    mask[0] = True
    mask[1, 70:] = True
    out = blockwise_attention(q, k, v, mask=mask, backend='cuda')
    scan = blockwise_attention(q, k, v, mask=mask, block_size=64, backend='scan')
    ref = fa.attention_reference(q, k, v, (~mask).float())[0]
    mean_v = v[0].mean(dim=1, keepdim=True).expand_as(out[0])
    for got in (out, scan):
        assert float((got - ref).abs().max() / ref.abs().max()) <= FLASH_FWD_TOL
        assert float((got[0] - mean_v).abs().max()) <= 1e-5
    _hold_flash_backward(fa, q, k, v, (~mask).float(), g)


def _hold_flash_backward(fa, q, k, v, kv, g):
    """dK / dV and dQ kernels against their plain versions from the plain
    residuals, reruns bit-identical, and dK / dV exactly 0 at the masked keys
    of every item that has a valid key."""
    o, lse = fa.attention_reference(q, k, v, kv)
    dout = torch.randn(o.shape, generator=g, device=q.device)
    di = (o * dout).sum(dim=-1)
    dk, dv = fa.attention_dkv(q, k, v, kv, dout, lse, di)
    dq = fa.attention_dq(q, k, v, kv, dout, lse, di)
    refs = (*fa.attention_dkv_reference(q, k, v, kv, dout, lse, di),
            fa.attention_dq_reference(q, k, v, kv, dout, lse, di))
    for got, ref in zip((dk, dv, dq), refs):
        assert float((got - ref).abs().max() / ref.abs().max()) <= FLASH_GRAD_TOL
    assert torch.equal(fa.attention_dkv(q, k, v, kv, dout, lse, di)[1], dv)
    assert torch.equal(fa.attention_dq(q, k, v, kv, dout, lse, di), dq)
    dead = (kv < 0.5) & (kv > 0.5).any(dim=1, keepdim=True)
    for got in (dk, dv):
        assert not bool(got.permute(0, 2, 1, 3)[dead].any())


@pytest.mark.parametrize('t,d,spans', [
    # per item, the (start, end) spans of valid keys; () = every key masked
    (1000, 64, (((0, 1000),), ((0, 256), (640, 1000)), ((128, 1000),), ())),
    (777, 128, (((0, 300), (500, 777)), (), ((1, 2),))),      # D = 128: dK / dV splits D
    (500, 32, (((3, 5), (100, 130)), (), ((250, 251),))),     # edges inside tiles
    (300, 160, (((0, 70), (200, 300)), (), ((299, 300),))),   # D = 160, 16-key dK / dV tiles
])
def test_flash_backward_skips_masked_tiles(card, t, d, spans):
    """Key masks that are not suffixes, with whole masked key tiles between
    valid keys, edges inside a tile and an item with every key masked: the
    tiles the backward kernels skip hold no valid key, so their results
    match the plain versions."""
    from pytorch_sound_tpu_torch.ops.cuda import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(t + d)
    n = len(spans)
    q, k, v = (torch.randn((n, 2, t, d), generator=g, device=card) for _ in range(3))
    kv = torch.zeros((n, t), device=card)
    for i, pairs in enumerate(spans):
        for a, b in pairs:
            kv[i, a:b] = 1.0
    _hold_flash_backward(fa, q, k, v, kv, g)


@pytest.mark.parametrize('tq,tk,d', [
    (130, 200, 16), (77, 300, 32), (500, 1000, 64), (200, 130, 128), (96, 333, 160),
    (65, 257, 256),
])
def test_flash_forward_skips_masked_tiles(card, tq, tk, d):
    """The forward kernel (o and lse) against its plain version at Tq != Tk:
    an item whose first key tiles are all masked (skipped; the first live
    tile's alpha = 0), an item with every key masked (the mean of v, no tile
    skipped), interior masked tiles, one valid key at the end, and no mask.
    K5a's ``lse=None`` gives the same o, and a rerun is bit-identical."""
    from pytorch_sound_tpu_torch.ops.cuda import flash_attention as fa
    g = torch.Generator(device=card).manual_seed(tq + tk + d)
    q = torch.randn((4, 2, tq, d), generator=g, device=card)
    k, v = (torch.randn((4, 2, tk, d), generator=g, device=card) for _ in range(2))
    spans = (((tk // 2, tk),), (), ((0, 5), (tk - 3, tk)), ((tk - 1, tk),))
    kv = torch.zeros((4, tk), device=card)
    for i, pairs in enumerate(spans):
        for a, b in pairs:
            kv[i, a:b] = 1.0
    assert not bool(fa.live_key_tiles(kv, fa.forward_key_tile(d))[0, 0])
    for mask in (kv, None):
        before = fa.attention_forward.launches
        o, lse = fa.attention_forward(q, k, v, mask)
        o_ref, lse_ref = fa.attention_reference(q, k, v, mask)
        o_only, none = fa.attention_forward(q, k, v, mask, with_lse=False)
        assert fa.attention_forward.launches == before + 2 and none is None
        for got, ref in ((o, o_ref), (lse, lse_ref)):
            assert got.shape == ref.shape
            assert float((got - ref).abs().max() / ref.abs().max()) <= FLASH_FWD_TOL
        assert torch.equal(o_only, o)
        again = fa.attention_forward(q, k, v, mask)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    mean_v = v[1].mean(dim=1, keepdim=True).expand_as(o_ref[1])
    assert float((fa.attention_forward(q, k, v, kv)[0][1] - mean_v).abs().max()) <= 1e-5


@pytest.mark.parametrize('n,ci,co,k,s,g,dil,p,t,misaligned', [
    (4, 64, 1, 3, 1, 1, 1, 1, 300, False),       # conv_post's one row: CUDA cores
    (2, 16, 8, 5, 1, 1, 1, 2, 201, False),       # 8 rows: CUDA cores
    (4, 64, 64, 41, 2, 4, 1, 20, 1000, False),   # 16 rows, t_out % 4 == 0: 16-byte gy copies
    (4, 128, 256, 41, 4, 8, 1, 20, 1001, False),  # 32 rows, t_out = 251
    (2, 128, 128, 5, 1, 1, 1, 2, 777, False),    # 128 rows
    (3, 32, 64, 7, 2, 2, 3, 9, 500, False),      # stride 2, dilation 3
    (2, 64, 128, 9, 4, 4, 2, 8, 1003, False),    # stride 4, dilation 2
    (2, 64, 64, 41, 2, 4, 1, 20, 1000, True),    # x and gy 4 bytes off 16-byte alignment
    (2, 3, 17, 5, 1, 1, 1, 2, 301, False),       # 17 rows, an odd partial-sum count, t_out 301
])
def test_weight_grad_kernels_match_plain(card, n, ci, co, k, s, g, dil, p, t, misaligned):
    """dw on both kernels (the tensor cores from DW_TC_MIN_ROWS rows per
    group, the CUDA cores below) against the plain version, reruns
    bit-identical, at geometries on each side of the route; where t_out % 4
    != 0 or gy is misaligned the tensor-core route pads gy in scratch."""
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    rng = np.random.default_rng(n * ci + co + k + t)

    def arr(*shape):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card)
        if misaligned:          # a contiguous view one float into its storage
            a = torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(shape)
            assert a.data_ptr() % 16 != 0
        return a

    conf = dict(stride=s, padding=p, groups=g, dilation=dil)
    t_out = gc.conv_out_len(t, k, s, p, dil)
    x, gy = arr(n, ci, t), arr(n, co, t_out)
    shape = (co, ci // g, k)
    before = gc.conv1d_weight_grad.launches
    dw = gc.conv1d_weight_grad(x, gy, shape, **conf)
    ref = gc.conv1d_weight_grad_reference(x, gy, shape, **conf)
    assert torch.equal(dw, gc.conv1d_weight_grad(x, gy, shape, **conf))
    assert gc.conv1d_weight_grad.launches == before + 2
    assert gc.dw_kernel(co // g) == ('conv_dw_kernel' if co // g >= 16 else 'conv_gemm_kernel')
    assert dw.shape == ref.shape
    assert float((dw - ref).abs().max() / ref.abs().max()) <= GC_GRAD_TOL


@pytest.mark.parametrize('n,ci,co,k,s,g,dil,p,t,misaligned', [
    (2, 15, 15, 5, 1, 1, 1, 2, 1000, False),      # 15 rows: CUDA cores
    (2, 16, 16, 5, 1, 1, 1, 2, 1000, False),      # 16 rows: tensor cores
    (2, 17, 17, 5, 1, 1, 1, 2, 1001, False),      # 17 rows: a ragged row tile
    (2, 8, 8, 5, 1, 1, 1, 2, 1000, False),        # 8 rows (v2's last upsample's)
    (352, 64, 128, 5, 1, 1, 1, 2, 10, False),     # period 11: t_out 10, tiles span items
    (352, 512, 1024, 5, 3, 1, 1, 2, 28, False),   # MPD L3 at period 11
    (4, 1024, 1024, 41, 1, 8, 1, 20, 33, False),  # MSD L5 at scale 2: t_out 33
    (3, 32, 64, 7, 2, 2, 3, 9, 500, False),       # stride 2, dilation 3
    (2, 48, 48, 5, 3, 3, 2, 4, 999, False),       # stride 3, dilation 2
    (2, 64, 128, 9, 4, 4, 2, 8, 1003, False),     # stride 4, dilation 2
    (2, 32, 64, 16, 8, 1, 1, 4, 1000, False),     # v2 upsample mirror: stride 8
    (2, 3, 17, 5, 1, 1, 1, 2, 301, False),        # cg k = 15: one partial stage, CUDA cores
    (2, 7, 17, 5, 1, 1, 1, 2, 301, False),        # cg k = 35: w packed to 16-byte rows
    (2, 64, 64, 41, 2, 4, 1, 20, 1000, True),     # every tensor 4 bytes off 16-byte alignment
])
def test_tap_kernels_match_plain(card, n, ci, co, k, s, g, dil, p, t, misaligned):
    """The forward (bias, slope) and dx (also with bias and slope: the
    ConvTranspose1d route) on both routes by rows per group, the tensor
    cores from TC_MIN_ROWS on: against their plain versions, reruns
    bit-identical."""
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    rng = np.random.default_rng(n * ci + co + k + t + s)

    def arr(*shape, scale=1.0):
        a = torch.from_numpy((rng.standard_normal(shape) * scale)
                             .astype(np.float32)).to(card)
        if misaligned:          # a contiguous view one float into its storage
            a = torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(shape)
            assert a.data_ptr() % 16 != 0
        return a

    conf = dict(stride=s, padding=p, groups=g, dilation=dil)
    t_out = gc.conv_out_len(t, k, s, p, dil)
    x, w = arr(n, ci, t), arr(co, ci // g, k, scale=(ci // g * k) ** -0.5)
    b_out, b_in, gy = arr(co), arr(ci), arr(n, co, t_out)
    assert gc.fwd_kernel(co // g, ci // g * k) == \
        ('conv_tap_kernel' if co // g >= 16 and ci // g * k >= 32 else 'conv_gemm_kernel')
    assert gc.dx_kernel(ci // g, gc.dx_depth(co, k, s, p, dil, g)) == \
        ('conv_tap_kernel' if ci // g >= 16 else 'conv_gemm_kernel')
    for mode in ('fwd', 'dx'):
        assert gc.tap_plan(mode, n, ci, t, co, t_out, k, **conf)['smem'] <= gc.TAP_MAX_SMEM
    before = (gc.conv1d_forward.launches, gc.conv1d_input_grad.launches)
    y = gc.conv1d_forward(x, w, b_out, slope=0.1, **conf)
    dx = gc.conv1d_input_grad(gy, w, t, **conf)
    dxb = gc.conv1d_input_grad(gy, w, t, b_in, slope=0.2, **conf)
    assert torch.equal(y, gc.conv1d_forward(x, w, b_out, slope=0.1, **conf))
    assert torch.equal(dx, gc.conv1d_input_grad(gy, w, t, **conf))
    assert (gc.conv1d_forward.launches, gc.conv1d_input_grad.launches) == \
        (before[0] + 2, before[1] + 3)
    y_ref = gc.grouped_conv1d_reference(x, w, b_out, slope=0.1, **conf)
    dx_ref = gc.conv1d_input_grad_reference(gy, w, t, **conf)
    dxb_ref = torch.nn.functional.leaky_relu(dx_ref + b_in[None, :, None], 0.2)
    for got, ref, tol in ((y, y_ref, GC_FWD_TOL), (dx, dx_ref, GC_GRAD_TOL),
                          (dxb, dxb_ref, GC_GRAD_TOL)):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.parametrize('kind', ['conv1d', 'conv2d', 'convt', 'gen_k11_d5_c8'])
def test_cudnn_default_route_matches_plain(card, kind):
    """The cuDNN route in precision 'default' on float32 tensors
    (``hifi_gan.rounded_conv``: cuDNN's fp32 conv of the bf16-rounded
    operands, its backward rounding the cotangent; cuDNN's TF32 off inside
    it whatever the global flag) against the plain version of the mode:
    forward, dx and dw within GC_FWD_TOL / GC_GRAD_TOL of the max and
    nearer it than 'highest' by RMS."""
    from pytorch_sound_tpu_torch.models.vocoders import hifi_gan as hg
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    rng = np.random.default_rng(len(kind))

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(card)
    transposed = kind == 'convt'
    if kind == 'conv2d':
        x, w, conf = arr(8, 32, 1024, 7), arr(64, 32, 5, 1, scale=0.1), dict(stride=(3, 1),
                                                                              padding=(2, 0))
    elif transposed:
        x, w, conf = arr(16, 64, 256), arr(64, 32, 16, scale=0.05), dict(stride=8, padding=4)
    elif kind == 'conv1d':
        x, w, conf = arr(16, 128, 2048), arr(256, 16, 41, scale=0.05), dict(
            stride=4, padding=20, groups=8)
    else:
        x, w, conf = arr(16, 8, 8192), arr(8, 8, 11, scale=0.1), dict(padding=25, dilation=5)
    b = arr(w.shape[1] if transposed else w.shape[0])
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    torch.backends.cudnn.allow_tf32 = True          # the route turns it off for itself
    y = hg.rounded_conv(xg, wg, b, transposed=transposed, **conf)
    gy = torch.randn(y.shape, generator=torch.Generator(device=card).manual_seed(1),
                     device=card)
    dx, dw = torch.autograd.grad(y, (xg, wg), gy)
    torch.backends.cudnn.allow_tf32 = False
    dims = x.ndim - 2

    def axis(v):
        return list(v) if isinstance(v, tuple) else [v] * dims
    args = (axis(conf.get('stride', 1)), axis(conf.get('padding', 0)),
            axis(conf.get('dilation', 1)), transposed, [0] * dims, conf.get('groups', 1))
    plain = {}
    for mode in ('default', 'highest'):
        xo, wo, go = gc._operands(mode, x, w, gy)
        plain[mode] = (torch.ops.aten.convolution(xo, wo, b, *args),) + tuple(
            torch.ops.aten.convolution_backward(go, xo, wo, None, *args,
                                                [True, True, False])[:2])
    for got, ref, hi, tol in zip((y, dx, dw), plain['default'], plain['highest'],
                                 (GC_FWD_TOL, GC_GRAD_TOL, GC_GRAD_TOL)):
        got = got.detach()
        assert got.shape == ref.shape
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol
        _ran_mode(got, ref, hi)
