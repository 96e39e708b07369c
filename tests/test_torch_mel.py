"""The port's log-mel (plain version, and the CPU dispatch of the fused
wrapper) against the JAX package's composite and its Pallas kernel
(interpret mode), at the JAX suite's tolerance (1e-4, tests/test_pallas.py:98)."""

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu import settings as s  # noqa: E402
from pytorch_sound_tpu.models.transforms import LogMelSpectrogram as JaxLogMel  # noqa: E402
from pytorch_sound_tpu.ops import filters as jax_filters  # noqa: E402
from pytorch_sound_tpu.ops import mel as jax_mel  # noqa: E402
from pytorch_sound_tpu.ops.pallas.logmel import fused_hifigan_mel as jax_fused_hifigan_mel  # noqa: E402
from pytorch_sound_tpu.ops.pallas.logmel import fused_log_mel as jax_fused_log_mel  # noqa: E402
from pytorch_sound_tpu_torch.models.transforms import LogMelSpectrogram  # noqa: E402
from pytorch_sound_tpu_torch.ops import filters as torch_filters  # noqa: E402
from pytorch_sound_tpu_torch.ops import mel as torch_mel  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import logmel  # noqa: E402


@pytest.mark.parametrize('shape,seed', [((2, 19137), 3), ((1, 12345), 4)])
def test_hifigan_mel_matches_jax(shape, seed):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    out = torch_mel.hifigan_mel_spectrogram(torch.from_numpy(wav)).numpy()
    ref = np.asarray(jax_mel.hifigan_mel_spectrogram(jnp.asarray(wav)))
    fused = np.asarray(jax_fused_hifigan_mel(jnp.asarray(wav)))
    assert out.shape == ref.shape == fused.shape == (shape[0], 80, shape[1] // 256)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(out, fused, atol=1e-4)
    # the fused wrapper runs the plain version for a CPU tensor
    wrapped = logmel.fused_hifigan_mel(torch.from_numpy(wav)).numpy()
    np.testing.assert_array_equal(wrapped, out)


def test_centered_log_mel_matches_jax():
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((2, 22050)) * 0.2).astype(np.float32)
    kw = dict(min_db=s.MIN_DB, max_db=s.MAX_DB, mel_min=s.MEL_MIN, mel_max=s.MEL_MAX)
    args = (s.SAMPLE_RATE, s.MEL_SIZE, s.N_FFT, s.WIN_LENGTH, s.HOP_LENGTH)
    out = torch_mel.log_mel_spectrogram(torch.from_numpy(wav), *args, **kw).numpy()
    ref = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(wav), *args, **kw))
    assert out.shape == ref.shape == (2, 80, 87)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    wrapped = logmel.fused_log_mel(torch.from_numpy(wav), *args, **kw).numpy()
    np.testing.assert_array_equal(wrapped, out)


def test_db_to_log_and_filter_match_jax():
    assert torch_mel.db_to_log(-100.0) == jax_mel.db_to_log(-100.0)
    np.testing.assert_array_equal(
        torch_mel.cached_mel_filter(22050, 1024, 80, 0.0, 8000.0),
        jax_mel.cached_mel_filter(22050, 1024, 80, 0.0, 8000.0))


@pytest.mark.parametrize('htk,norm,fmax', [(False, 'slaney', 8000.0), (True, None, None)])
def test_port_filters_equal_jax_filters(htk, norm, fmax):
    """The port's numpy constants are the JAX package's, bit for bit."""
    np.testing.assert_array_equal(
        torch_filters.mel_filterbank(16000, 512, 40, 20.0, fmax, htk=htk, norm=norm),
        jax_filters.mel_filterbank(16000, 512, 40, 20.0, fmax, htk=htk, norm=norm))
    for n_fft, win in ((1024, 1024), (1024, 800)):
        np.testing.assert_array_equal(torch_filters.stft_basis(n_fft, win),
                                      jax_filters.stft_basis(n_fft, win, 'hann'))
        np.testing.assert_array_equal(
            torch_filters.pad_center(torch_filters.hann_window(win), n_fft),
            jax_filters.pad_center(jax_filters.hann_window(win), n_fft))


def test_kernel_constants_trim_unused_bins():
    """The FFT kernels' tables: the plain version's fp64 window, numpy's
    twiddles to the bit, only the bins the filterbank weights (372 of 513 at
    fmax 8 kHz), and band ranges that cover every nonzero of the filterbank
    and nothing else."""
    c = logmel._constants(22050, 1024, 1024, 80, 0.0, 8000.0, 'cpu')
    np.testing.assert_array_equal(c.window.numpy(), torch_mel._cached_window(1024, 1024))
    assert c.window.dtype == c.twiddles.dtype == c.split.dtype == torch.float64
    tw = np.exp(-2j * np.pi * np.arange(512) / 512)
    st = np.exp(-2j * np.pi * np.arange(372) / 1024)
    np.testing.assert_array_equal(c.twiddles.numpy(), np.stack([tw.real, tw.imag], -1))
    np.testing.assert_array_equal(c.split.numpy(), np.stack([st.real, st.imag], -1))
    full = torch_mel.cached_mel_filter(22050, 1024, 80, 0.0, 8000.0)
    assert c.mel_w.shape == (80, 372) and c.mel_w.dtype == torch.float32
    assert not full[:, 372:].any() and full[:, 371].any()
    np.testing.assert_array_equal(c.mel_w.numpy(), full[:, :372])
    inside = np.zeros(full[:, :372].shape, dtype=bool)
    for m, (k0, k1) in enumerate(c.bands.numpy()):
        inside[m, k0:k1] = True
    np.testing.assert_array_equal(inside, full[:, :372] != 0)
    covered = np.zeros_like(inside)
    for k, (m0, m1) in enumerate(c.bin_mels.numpy()):
        covered[m0:m1, k] = True
    np.testing.assert_array_equal(covered, inside)


def test_fused_wrapper_guards():
    wav = torch.zeros((2, 4096))
    with pytest.raises(ValueError, match='expects'):
        logmel.fused_hifigan_mel(wav[0])
    with pytest.raises(ValueError, match='geometry'):
        logmel.fused_log_mel(wav, n_fft=1024, win_length=800)
    with pytest.raises(RuntimeError, match='cpu or cuda'):
        logmel.fused_hifigan_mel(torch.zeros((2, 4096), device='meta'))


SHORT = (1, 2, 255, 256, 383, 384, 385)


@pytest.mark.parametrize('t', SHORT)
def test_short_inputs_match_jax(t):
    """Inputs the reflect pad exceeds (HiFi-GAN pad 384, centered pad 512):
    both conventions reflect by numpy's rule, as ``jnp.pad`` does, and give
    JAX's shapes, (2, 80, 0) below one HiFi-GAN frame, and values at 1e-4.
    The fused wrappers' CPU path is the plain version, bit for bit."""
    rng = np.random.default_rng(100 + t)
    wav = (rng.standard_normal((2, t)) * 0.2).astype(np.float32)
    x = torch.from_numpy(wav)
    out = torch_mel.hifigan_mel_spectrogram(x).numpy()
    ref = np.asarray(jax_mel.hifigan_mel_spectrogram(jnp.asarray(wav)))
    assert out.shape == ref.shape == (2, 80, max(0, 1 + (t - 256) // 256))
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_array_equal(logmel.fused_hifigan_mel(x).numpy(), out)

    kw = dict(min_db=s.MIN_DB, max_db=s.MAX_DB, mel_min=s.MEL_MIN, mel_max=s.MEL_MAX)
    args = (s.SAMPLE_RATE, s.MEL_SIZE, s.N_FFT, s.WIN_LENGTH, s.HOP_LENGTH)
    out = torch_mel.log_mel_spectrogram(x, *args, **kw).numpy()
    ref = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(wav), *args, **kw))
    assert out.shape == ref.shape == (2, 80, 1 + t // 256)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_array_equal(logmel.fused_log_mel(x, *args, **kw).numpy(), out)


def test_reflect_index_is_numpys():
    for t, pad in ((1, 4), (2, 7), (3, 9), (5, 4), (5, 12), (384, 384), (385, 384)):
        x = np.arange(t)
        np.testing.assert_array_equal(x[torch_mel.reflect_index(t, pad)],
                                      np.pad(x, (pad, pad), mode='reflect'))


@pytest.mark.parametrize('sr,n_fft,hop,n_mels', [(16000, 400, 100, 40), (8000, 128, 32, 20)])
def test_direct_geometry_matches_jax(sr, n_fft, hop, n_mels):
    """Geometries whose n_fft is not a power of two from 256 to 4096, which
    the card kernel takes on its mixed-radix FFT (400: radix 8, 5, 5; 128:
    8, 8; until that FFT took them, on the direct DFT): the port's
    fused_log_mel in both conventions against JAX's fused_log_mel (Pallas in
    interpret mode), and LogMelSpectrogram on (N, T) and (N, 1, T) against
    JAX's, at 1e-4."""
    assert logmel.fft_path(n_fft)
    rng = np.random.default_rng(n_fft)
    wav = (rng.standard_normal((2, 12 * n_fft + 7)) * 0.2).astype(np.float32)
    x = torch.from_numpy(wav)
    conventions = {
        'centered': dict(min_db=-100.0, max_db=20.0, mel_max=None),
        'hifigan': dict(pad=(n_fft - hop) // 2, power_eps=1e-9, log_floor=1e-5),
    }
    for kw in conventions.values():
        out = logmel.fused_log_mel(x, sr, n_mels, n_fft, n_fft, hop, **kw).numpy()
        ref = np.asarray(jax_fused_log_mel(jnp.asarray(wav), sr, n_mels, n_fft, n_fft, hop,
                                           **kw))
        assert out.shape == ref.shape and out.shape[-1] > 10
        np.testing.assert_allclose(out, ref, atol=1e-4)
    args = (sr, n_mels, n_fft, n_fft, hop, s.MIN_DB, s.MAX_DB)
    for inp in (wav, wav[:, None, :]):
        out = LogMelSpectrogram(*args)(torch.from_numpy(inp)).numpy()
        ref = np.asarray(JaxLogMel(*args)(jnp.asarray(inp)))
        assert out.shape == ref.shape == inp.shape[:-1] + (n_mels, 1 + inp.shape[-1] // hop)
        np.testing.assert_allclose(out, ref, atol=1e-4)


def test_constants_made_in_inference_mode_serve_autograd():
    """The plain version's device constants (window, filterbank), first made
    by a call under ``torch.inference_mode`` (as a serving encode makes
    them), are normal tensors: a later differentiable call at the same
    geometry saves them for backward."""
    wav = torch.from_numpy((np.random.default_rng(9).standard_normal((1, 3000)) * 0.2)
                           .astype(np.float32))
    kw = dict(n_fft=768, window_size=768, hop_size=192)     # a geometry of this test alone
    with torch.inference_mode():
        first = torch_mel.hifigan_mel_spectrogram(wav, **kw)
    w = wav.clone().requires_grad_(True)
    out = torch_mel.hifigan_mel_spectrogram(w, **kw)
    out.sum().backward()
    assert torch.equal(out.detach(), first) and bool(torch.isfinite(w.grad).all())


@pytest.mark.parametrize('signal', ['noise', 'tones'])
def test_precision_modes_against_jax_bf16x3(signal):
    """K2's ``precision=`` at the extract_features settings (centered, 80
    mels to 8 kHz, clipped to -50 .. 30 dB). The port computes every mode
    as 'highest' (bit-identical results), and so sits closer to fp64 than
    JAX's kernel at 'bf16x3' (interpret mode) does. Measured distance of
    the port from JAX's 'bf16x3' output: 3.0e-5 on noise, 7.7e-2 on pure
    tones (whose quiet bands the bf16 split moves); from JAX's 'highest':
    1.4e-6 and 3.4e-3 (fp32 rounding of those bands on both sides)."""
    rng = np.random.default_rng(5)
    if signal == 'noise':
        wav = (rng.standard_normal((2, 22050)) * 0.1).astype(np.float32)
    else:
        t = np.arange(22050) / 22050
        wav = np.stack([0.3 * np.sin(2 * np.pi * 220 * t),
                        0.2 * np.sin(2 * np.pi * 440 * t)
                        + 0.001 * rng.standard_normal(22050)]).astype(np.float32)
    args = (s.SAMPLE_RATE, s.MEL_SIZE, s.N_FFT, s.WIN_LENGTH, s.HOP_LENGTH, s.MIN_DB,
            s.MAX_DB, s.MEL_MIN, s.MEL_MAX)
    x = torch.from_numpy(wav)
    port = {p: logmel.fused_log_mel(x, *args, precision=p).numpy()
            for p in logmel.PRECISIONS}
    fp64 = logmel.fused_log_mel(x.double(), *args).numpy()
    jax_hi, jax_b3 = (np.asarray(jax_fused_log_mel(jnp.asarray(wav), *args, precision=p))
                      for p in ('highest', 'bf16x3'))
    assert all(np.array_equal(port[p], port['highest']) for p in logmel.PRECISIONS)
    out = port['bf16x3']
    assert out.shape == jax_b3.shape == (2, 80, 87)
    to_b3, to_hi = np.abs(out - jax_b3).max(), np.abs(out - jax_hi).max()
    assert np.abs(out - fp64).max() <= np.abs(jax_b3 - fp64).max()
    assert to_hi <= (1e-4 if signal == 'noise' else 5e-3), to_hi
    assert to_b3 <= (1e-4 if signal == 'noise' else 0.1), to_b3
    with pytest.raises(ValueError, match='precision'):
        logmel.fused_log_mel(x, *args, precision='fp8')
