"""The port's tensor resampler (``ops/resample.py``) against the JAX
package's and the native ``ts_resample``: tests/test_resample.py's cases
and parameters, within its 2e-6, and the masked RMS normalisation against
JAX's."""

import math

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.ops import resample as jax_resample  # noqa: E402
from pytorch_sound_tpu_torch import native  # noqa: E402
from pytorch_sound_tpu_torch.ops.resample import (kaiser_polyphase_bank,  # noqa: E402
                                                  resample_out_len, resample_poly,
                                                  rms_normalize)


def _ref_resample(x, orig_sr, target_sr, taps=24):
    """Scalar transcription of the native ts_resample loop."""
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    if up == down:
        return x.copy()
    bank = kaiser_polyphase_bank(up, down)
    h_src = taps // 2
    n_in = len(x)
    n_out = (n_in * up + down - 1) // down
    out = np.zeros(n_out, np.float32)
    for m in range(n_out):
        up_idx = m * down
        src0 = up_idx // up - h_src
        h = bank[up_idx % up]
        acc = 0.0
        for j in range(taps):
            s = src0 + j
            if 0 <= s < n_in:
                acc += float(h[j]) * float(x[s])
        out[m] = acc
    return out


def _both(x, orig_sr, target_sr):
    got = resample_poly(torch.from_numpy(x), orig_sr, target_sr).numpy()
    ref = np.asarray(jax_resample.resample_poly(jnp.asarray(x), orig_sr, target_sr))
    return got, ref


@pytest.mark.parametrize('orig_sr,target_sr,n', [
    (48000, 22050, 4801),    # the standard corpus downsample (147/320)
    (44100, 22050, 2000),    # 1/2
    (16000, 22050, 1600),    # upsample with large up (441/320)
    (22050, 44100, 999),     # 2/1
    (22050, 22050, 500),     # identity
])
def test_resample_matches_native_semantics(orig_sr, target_sr, n):
    rng = np.random.default_rng(n)
    x = (0.3 * rng.standard_normal(n)).astype(np.float32)
    ref = _ref_resample(x, orig_sr, target_sr)
    got, theirs = _both(x, orig_sr, target_sr)
    assert got.shape[-1] == resample_out_len(n, orig_sr, target_sr) == len(ref)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_allclose(got, theirs, atol=2e-6)
    # the float64 product rounds as the native loop's double accumulator
    np.testing.assert_array_equal(got, native.resample(x, orig_sr, target_sr))
    np.testing.assert_array_equal(kaiser_polyphase_bank(7, 5),
                                  jax_resample.kaiser_polyphase_bank(7, 5))


def test_resample_batched():
    """(3, T) and (2, 1, T) batches resample row by row: the scalar loop's
    rows, JAX's batch, and the 1-D call's rows bit for bit."""
    rng = np.random.default_rng(1)
    xb = (0.3 * rng.standard_normal((3, 4801))).astype(np.float32)
    got, theirs = _both(xb, 48000, 22050)
    ref = np.stack([_ref_resample(r, 48000, 22050) for r in xb])
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_allclose(got, theirs, atol=2e-6)
    for i, row in enumerate(xb):
        np.testing.assert_array_equal(_both(row, 48000, 22050)[0], got[i])
    deep = resample_poly(torch.from_numpy(xb[:2, None]), 48000, 22050).numpy()
    np.testing.assert_array_equal(deep[:, 0], got[:2])


def test_resample_preserves_tone_frequency():
    """A 1 kHz tone stays a 1 kHz tone through 48000 -> 22050."""
    sr_in, sr_out = 48000, 22050
    t = np.arange(sr_in) / sr_in
    x = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    y, theirs = _both(x, sr_in, sr_out)
    np.testing.assert_allclose(y, theirs, atol=2e-6)
    spec = np.abs(np.fft.rfft(y[200:-200] * np.hanning(len(y) - 400)))
    peak_hz = np.argmax(spec) * sr_out / (len(y) - 400)
    assert abs(peak_hz - 1000.0) < 5.0
    assert abs(np.abs(y[500:-500]).max() - 1.0) < 0.02


def test_rms_normalize_masked_lengths():
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((2, 1000))).astype(np.float32)
    xp = np.pad(x, [(0, 0), (0, 200)])
    lengths = np.asarray([1000, 700])
    out = rms_normalize(torch.from_numpy(xp), lengths=torch.from_numpy(lengths)).numpy()
    ref = np.asarray(jax_resample.rms_normalize(jnp.asarray(xp), lengths=jnp.asarray(lengths)))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    target = 10 ** (-23.0 / 20.0)
    assert abs(np.sqrt((out[0, :1000] ** 2).mean()) - target) < 1e-4
    assert (out[:, 1000:] == 0).all()          # padding untouched (zeros)
    whole = rms_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(whole, np.asarray(jax_resample.rms_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('orig_sr,target_sr', [
    (8000, 22050),     # large up factor (441/160)
    (48000, 16000),    # exact 1/3
    (22050, 48000),    # large up (320/147)
])
def test_resample_extreme_ratios(orig_sr, target_sr):
    rng = np.random.default_rng(orig_sr)
    x = (0.3 * rng.standard_normal(3000)).astype(np.float32)
    ref = _ref_resample(x, orig_sr, target_sr)
    got, theirs = _both(x, orig_sr, target_sr)
    assert got.shape == ref.shape == theirs.shape
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_allclose(got, theirs, atol=2e-6)
