"""The port's DSP layer against the JAX package's on the CPU: the cases of
``tests/test_dsp.py``, each feeding the JAX function and the port's
counterpart the same numpy input. Bases, windows and banks are held
bit-equal; values at the JAX tests' tolerances or tighter: STFT / iSTFT 2e-4
absolute and 3e-6 of the spectrum's peak, PQMF 1e-5, pre-emphasis 1e-6,
Griffin-Lim from the zero phase 1e-4 of the output's peak away from its
first and last frame. Inputs shorter than one frame give JAX's empty
shapes."""

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.fft  # noqa: E402
import scipy.signal  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu import settings as s  # noqa: E402
from pytorch_sound_tpu.models import sound as jax_sound_mod  # noqa: E402
from pytorch_sound_tpu.models import transforms as JT  # noqa: E402
from pytorch_sound_tpu.ops import filters as jax_filters  # noqa: E402
from pytorch_sound_tpu.ops import mel as jax_mel  # noqa: E402
from pytorch_sound_tpu.ops import sound as jax_sound  # noqa: E402
from pytorch_sound_tpu.ops import stft as jax_stft  # noqa: E402
from pytorch_sound_tpu_torch.models import sound as sound_mod  # noqa: E402
from pytorch_sound_tpu_torch.models import transforms as T  # noqa: E402
from pytorch_sound_tpu_torch.ops import filters, mel as mel_ops, stft as stft_ops  # noqa: E402
from pytorch_sound_tpu_torch.ops import pqmf as pqmf_ops, sound as sound_ops  # noqa: E402

N_FFT, HOP, WIN = s.N_FFT, s.HOP_LENGTH, s.WIN_LENGTH
STFT_ATOL = 2e-4           # tests/test_dsp.py:47
STFT_RTOL = 3e-6           # of the spectrum's peak (JAX's rfft and matmul on the CPU)
LOGMEL_TOL = 1e-4          # tests/test_torch_mel.py
PQMF_TOL = 1e-5            # tests/test_dsp.py:197
PRE_TOL = 1e-6             # tests/test_dsp.py:216
MEL_KW = dict(min_db=s.MIN_DB, max_db=s.MAX_DB, mel_min=s.MEL_MIN, mel_max=s.MEL_MAX)


@pytest.fixture(scope='module')
def batch_wav():
    rng = np.random.default_rng(7)
    return rng.standard_normal((2, 22050)).astype(np.float32)


def t_(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close_to_peak(got, ref, atol=STFT_ATOL, rtol=STFT_RTOL):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= atol and err <= rtol * float(np.abs(ref).max()), (err, np.abs(ref).max())


def torch_stft(x, window=None):
    w = torch.hann_window(WIN) if window is None else window
    return torch.stft(torch.from_numpy(x), N_FFT, HOP, WIN, w, center=True,
                      pad_mode='reflect', normalized=False, onesided=True,
                      return_complex=True)


@pytest.mark.parametrize('window', ['hann', 'hamming', 'blackman', ('kaiser', 8.0)])
@pytest.mark.parametrize('method', ['fft', 'matmul'])
def test_stft_matches_jax_and_torch(batch_wav, window, method):
    real, imag = stft_ops.stft(torch.from_numpy(batch_wav), N_FFT, HOP, WIN, window=window,
                               method=method)
    j_real, j_imag = jax_stft.stft(jnp.asarray(batch_wav), N_FFT, HOP, WIN, window=window,
                                   method=method)
    assert real.shape == j_real.shape == (2, N_FFT // 2 + 1, 87)
    close_to_peak(real, j_real)
    close_to_peak(imag, j_imag)
    ref = torch_stft(batch_wav, t_(filters.get_window_array(window, WIN)))
    close_to_peak(real, ref.real)
    close_to_peak(imag, ref.imag)


@pytest.mark.parametrize('length', [None, 22050, 20000, 23000])
@pytest.mark.parametrize('method', ['fft', 'matmul'])
def test_istft_matches_jax_and_torch(batch_wav, method, length):
    """torch.istft's crop for an explicit length: [n_fft // 2, + length) of
    the raw overlap-add, zero-padded where it is short. Past the signal's
    22050 samples the envelope falls to ~0 and the quotient holds no
    digits, so values are compared up to there; the zero padding beyond the
    overlap-add is exact."""
    spec = torch_stft(batch_wav)
    real, imag = spec.real.contiguous(), spec.imag.contiguous()
    y = stft_ops.istft(real, imag, N_FFT, HOP, WIN, length=length, method=method).numpy()
    ref = np.asarray(jax_stft.istft(jnp.asarray(real.numpy()), jnp.asarray(imag.numpy()),
                                    N_FFT, HOP, WIN, length=length, method=method))
    assert y.shape == ref.shape == (2, length or 22016)
    np.testing.assert_allclose(y[:, :22050], ref[:, :22050], atol=1e-5)
    ola_end = 86 * HOP + N_FFT - N_FFT // 2      # the raw overlap-add's end, cropped
    assert not y[:, ola_end:].any() and not ref[:, ola_end:].any()
    if length is not None and length <= 22050:
        y_t = torch.istft(spec, N_FFT, HOP, WIN, torch.hann_window(WIN), length=length)
        np.testing.assert_allclose(y, y_t.numpy(), atol=1e-4)


@pytest.mark.parametrize('method', ['fft', 'matmul'])
def test_stft_shorter_than_a_frame_matches_jax(method):
    """No frame: JAX's empty (N, F, 0) pair (the FFT is never called),
    through stft, spectrogram_magnitude and audio2mel."""
    x = np.random.default_rng(3).standard_normal((2, 300)).astype(np.float32)
    real, imag = stft_ops.stft(torch.from_numpy(x), 512, 128, center=False, method=method)
    j_real, j_imag = jax_stft.stft(jnp.asarray(x), 512, 128, center=False, method=method)
    assert real.shape == imag.shape == j_real.shape == j_imag.shape == (2, 257, 0)
    mag = stft_ops.spectrogram_magnitude(torch.from_numpy(x), 512, 128, center=False,
                                         method=method)
    j_mag = jax_stft.spectrogram_magnitude(jnp.asarray(x), 512, 128, center=False,
                                           method=method)
    assert mag.shape == j_mag.shape == (2, 257, 0)
    short = x[:, :100]
    mel = mel_ops.audio2mel(torch.from_numpy(short), method=method)
    j_mel = jax_mel.audio2mel(jnp.asarray(short), method=method)
    assert mel.shape == j_mel.shape == (2, 80, 0)
    assert T.Audio2Mel()(torch.from_numpy(short[:, None])).shape == \
        JT.Audio2Mel()(jnp.asarray(short[:, None])).shape


@pytest.mark.parametrize('n_iter,momentum', [(0, 0.99), (8, 0.99), (32, 0.0)])
def test_griffin_lim_matches_jax(batch_wav, n_iter, momentum):
    """From the zero phase (``rng=None``), within 1e-4 of the output's peak
    away from the first and last frame, where the iSTFT divides by a
    window envelope of ~0; at the signal's length and past it. The momentum
    grows fp32 round-off in both packages alike: at 0.99 and 32 iterations
    each lies 2-3e-4 of the peak from a float64 run (the port 3.2e-4, JAX
    1.9e-4 on this input), so the long run with momentum is compared at
    momentum 0."""
    from pytorch_sound_tpu.ops.griffin_lim import griffin_lim as jax_griffin_lim
    from pytorch_sound_tpu_torch.ops.griffin_lim import griffin_lim
    mag = np.abs(torch_stft(batch_wav[:, :11025]).numpy())
    for length in (None, 11025, 12000):
        got = griffin_lim(torch.from_numpy(mag), N_FFT, HOP, WIN, n_iter=n_iter,
                          momentum=momentum, length=length).numpy()
        ref = np.asarray(jax_griffin_lim(jnp.asarray(mag), N_FFT, HOP, WIN, n_iter=n_iter,
                                         momentum=momentum, length=length))
        assert got.shape == ref.shape
        inner = slice(N_FFT, min(got.shape[-1], 11025) - N_FFT)
        err = float(np.abs(got[:, inner] - ref[:, inner]).max())
        assert err <= 1e-4 * float(np.abs(ref[:, inner]).max()), (length, err)


def test_griffin_lim_reconstruction():
    """Fast-GLA from a random phase recovers a consistent spectrogram
    (interior spectral convergence < 6 %), as tests/test_dsp.py holds JAX's."""
    from pytorch_sound_tpu_torch.ops.griffin_lim import griffin_lim
    sr = 22050
    tt = np.arange(sr) / sr
    sig = (0.5 * np.sin(2 * np.pi * 440 * tt)
           + 0.25 * np.sin(2 * np.pi * 880 * tt)).astype(np.float32)[None]
    mag = stft_ops.spectrogram_magnitude(torch.from_numpy(sig), N_FFT, HOP, WIN)
    rec = griffin_lim(mag, N_FFT, HOP, WIN, n_iter=100, momentum=0.9, length=sr,
                      rng=torch.Generator().manual_seed(0))
    assert rec.shape == (1, sr)
    a = stft_ops.spectrogram_magnitude(rec, N_FFT, HOP, WIN).numpy()[..., 4:-4]
    b = mag.numpy()[..., 4:-4]
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.06


@pytest.mark.parametrize('hop', [256, 300])
def test_frame_and_overlap_add_match_jax(hop):
    """Framing, and the overlap-add by shifted sums (hop | frame) and by
    F.fold (JAX's scatter-add otherwise)."""
    rng = np.random.default_rng(hop)
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    frames = stft_ops.frame(torch.from_numpy(x), 1024, hop)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jax_stft.frame(jnp.asarray(x),
                                                                           1024, hop)))
    f = rng.standard_normal((2, 9, 1024)).astype(np.float32)
    np.testing.assert_allclose(stft_ops.overlap_add(torch.from_numpy(f), hop).numpy(),
                               np.asarray(jax_stft.overlap_add(jnp.asarray(f), hop)), atol=1e-6)
    assert stft_ops.frame(torch.from_numpy(x[:, :1000]), 1024, hop).shape == (2, 0, 1024)


@pytest.mark.parametrize('window', ['hann', 'hamming'])
def test_conv_stft_roundtrip_and_parity(batch_wav, window):
    """The conv STFT and its pinv inverse at 512 / 128 (the pinv of the
    1024-point basis is an SVD that dominates the test's time)."""
    st = T.STFT(filter_length=512, hop_length=128, window=window)
    mag, phase = st.transform(torch.from_numpy(batch_wav))
    j_mag, j_phase = JT.STFT(filter_length=512, hop_length=128, window=window).transform(
        jnp.asarray(batch_wav))
    assert mag.shape[1] == 257
    close_to_peak(mag, j_mag)
    loud = np.asarray(j_mag) > 1e-2 * float(np.abs(j_mag).max())
    dphase = np.angle(np.exp(1j * (phase.numpy() - np.asarray(j_phase))))
    assert float(np.abs(dphase[loud]).max()) <= 1e-4
    rec = st.inverse(mag, phase).numpy()
    j_rec = np.asarray(JT.STFT(filter_length=512, hop_length=128, window=window).inverse(
        j_mag, j_phase))
    assert rec.shape == j_rec.shape
    np.testing.assert_allclose(rec, batch_wav[:, :rec.shape[-1]], atol=1e-4)
    np.testing.assert_allclose(rec, j_rec, atol=1e-5)


def test_conv_stft_magnitude_matches_torch(batch_wav):
    ref = torch_stft(batch_wav).abs().numpy()
    mag, _ = T.STFT(filter_length=WIN, hop_length=HOP).transform(torch.from_numpy(batch_wav))
    close_to_peak(mag, ref)


CONSTANTS = {
    'window_hann': lambda f: f.get_window_array('hann', 400),
    'window_kaiser': lambda f: f.get_window_array(('kaiser', 8.0), 1024),
    'dft': lambda f: f.dft_basis(400),
    'stft_basis': lambda f: f.stft_basis(1024, 800, 'hamming'),
    'istft_pinv': lambda f: f.istft_pinv_basis(256, 64, 200, 'hann'),
    'dct_ortho': lambda f: f.dct_matrix(40, 80, 'ortho'),
    'dct_none': lambda f: f.dct_matrix(13, 40, None),
    'pqmf_prototype': lambda f: f.pqmf_prototype(62, 0.15, 9.0),
    'pqmf_banks': lambda f: np.stack(f.pqmf_banks(4, 62, 0.15, 9.0)),
    'mel_htk': lambda f: f.mel_filterbank(22050, 1024, 80, 0.0, 8000.0, htk=True, norm=None),
}


@pytest.mark.parametrize('case', sorted(CONSTANTS))
def test_constants_equal_jax(case):
    """The port's copies of the numpy constants are the JAX package's, bit
    for bit."""
    make = CONSTANTS[case]
    np.testing.assert_array_equal(make(filters), make(jax_filters))


def test_mel_filterbank_properties():
    fb = filters.mel_filterbank(s.SAMPLE_RATE, N_FFT, s.MEL_SIZE, s.MEL_MIN, s.MEL_MAX)
    assert fb.shape == (80, 513) and (fb >= 0).all() and (fb.sum(axis=1) > 0).all()
    assert (np.diff(fb.argmax(axis=1)) > 0).all() and fb.max() < 0.1
    fftfreqs = np.linspace(0, s.SAMPLE_RATE / 2, 513)
    assert fb[:, fftfreqs > s.MEL_MAX + 100].sum() == 0
    np.testing.assert_array_equal(
        fb, jax_filters.mel_filterbank(s.SAMPLE_RATE, N_FFT, s.MEL_SIZE, s.MEL_MIN, s.MEL_MAX))


def test_mel_filterbank_slaney_closed_form():
    sr, n_fft, n_mels, fmin, fmax = 22050, 1024, 80, 0.0, 8000.0
    fb = filters.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)

    def hz2mel(f):
        return f / (200. / 3.) if f < 1000 else 15. + np.log(f / 1000.) / (np.log(6.4) / 27.)

    def mel2hz(m):
        return m * (200. / 3.) if m < 15 else 1000. * np.exp((np.log(6.4) / 27.) * (m - 15.))

    pts = [mel2hz(m) for m in np.linspace(hz2mel(fmin), hz2mel(fmax), n_mels + 2)]
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    for i in [0, 1, 40, 79]:
        lo, ctr, hi = pts[i], pts[i + 1], pts[i + 2]
        for k in [1, 50, 150, 370]:
            f = fftfreqs[k]
            tri = max(0.0, min((f - lo) / (ctr - lo), (hi - f) / (hi - ctr)))
            assert np.isclose(fb[i, k], tri * 2.0 / (hi - lo), atol=1e-10)


@pytest.mark.parametrize('rank', [2, 3])
def test_log_mel_spectrogram_matches_jax(batch_wav, rank):
    """LogMelSpectrogram at the settings' geometry (the kernel's route on a
    card) on (N, T) and (N, 1, T), against JAX's module and the formula."""
    wav = batch_wav if rank == 2 else batch_wav[:, None, :]
    args = (s.SAMPLE_RATE, s.MEL_SIZE, N_FFT, WIN, HOP)
    mel = T.LogMelSpectrogram(*args, **MEL_KW)(torch.from_numpy(wav)).numpy()
    ref = np.asarray(JT.LogMelSpectrogram(*args, **MEL_KW)(jnp.asarray(wav)))
    assert mel.shape == ref.shape == wav.shape[:-1] + (80, 87)
    np.testing.assert_allclose(mel, ref, atol=LOGMEL_TOL)
    lo, hi = mel_ops.db_to_log(s.MIN_DB), mel_ops.db_to_log(s.MAX_DB)
    fb = filters.mel_filterbank(s.SAMPLE_RATE, N_FFT, 80, 0, 8000)
    formula = np.log(fb @ torch_stft(batch_wav).abs().numpy() + 1e-6).clip(lo, hi)
    np.testing.assert_allclose(mel.reshape(formula.shape), formula, atol=1e-3)


def test_log_mel_unfused_geometry_matches_jax(batch_wav):
    """hop not dividing n_fft is off the fused route in both packages: the
    composite."""
    args = (s.SAMPLE_RATE, s.MEL_SIZE, 1024, 1024, 300)
    mel = T.LogMelSpectrogram(*args, **MEL_KW)(torch.from_numpy(batch_wav)).numpy()
    ref = np.asarray(JT.LogMelSpectrogram(*args, **MEL_KW)(jnp.asarray(batch_wav)))
    assert not T.LogMelSpectrogram(*args).fused()
    np.testing.assert_allclose(mel, ref, atol=LOGMEL_TOL)


def test_hifigan_mel_against_reference_formula(batch_wav):
    x = torch.from_numpy(batch_wav)
    pad = (N_FFT - HOP) // 2
    xp = torch.nn.functional.pad(x.unsqueeze(1), [pad, pad], mode='reflect').squeeze(1)
    spec = torch.stft(xp, N_FFT, hop_length=HOP, win_length=WIN,
                      window=torch.hann_window(WIN), center=False, return_complex=True)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    fb = torch.from_numpy(filters.mel_filterbank(22050, N_FFT, 80, 0., 8000.)).float()
    ref = torch.log(torch.clamp(fb @ mag, min=1e-5)).numpy()
    mel = mel_ops.hifigan_mel_spectrogram(x).numpy()
    np.testing.assert_allclose(mel, ref, atol=2e-3)
    np.testing.assert_allclose(
        mel, np.asarray(jax_mel.hifigan_mel_spectrogram(jnp.asarray(batch_wav))),
        atol=LOGMEL_TOL)


def test_dct_and_mel_to_mfcc_match_scipy_and_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((80, 5)).astype(np.float32)
    ref = scipy.fft.dct(x, axis=0, norm='ortho')[:40]
    np.testing.assert_allclose(filters.dct_matrix(40, 80, 'ortho') @ x, ref, atol=1e-5)
    mel = rng.standard_normal((2, 80, 7)).astype(np.float32)
    got = T.MelToMFCC(40, 80)(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, np.asarray(JT.MelToMFCC(40, 80)(jnp.asarray(mel))),
                               atol=1e-5)
    np.testing.assert_array_equal(mel_ops.cached_dct(40, 80), jax_mel.cached_dct(40, 80))


def test_mfcc_matches_jax(batch_wav):
    """MFCC on (N, 1, T), the input JAX's kernel route could not take: its
    log-mel through LogMelSpectrogram."""
    args = (s.SAMPLE_RATE, s.MEL_SIZE, N_FFT, WIN, s.MFCC_SIZE, HOP, s.MIN_DB, s.MAX_DB,
            s.MEL_MIN, s.MEL_MAX)
    wav = batch_wav[:, None, :]
    out = T.MFCC(*args)(torch.from_numpy(wav)).numpy()
    ref = np.asarray(JT.MFCC(*args)(jnp.asarray(wav)))
    assert out.shape == ref.shape == (2, 1, s.MFCC_SIZE, 87)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(
        mel_ops.mfcc(torch.from_numpy(wav), *args).numpy(), out, atol=1e-6)


def test_audio2mel_and_log_mel_scale_match_jax(batch_wav):
    a2m = T.Audio2Mel()(torch.from_numpy(batch_wav[:, None, :])).numpy()
    np.testing.assert_allclose(a2m, np.asarray(JT.Audio2Mel()(jnp.asarray(batch_wav[:, None]))),
                               atol=LOGMEL_TOL)
    mag = torch_stft(batch_wav).abs().numpy()
    args = (s.SAMPLE_RATE, s.MEL_SIZE, N_FFT, s.MIN_DB, s.MAX_DB, s.MEL_MIN, s.MEL_MAX)
    got = T.LogMelScale(*args)(torch.from_numpy(mag)).numpy()
    np.testing.assert_allclose(got, np.asarray(JT.LogMelScale(*args)(jnp.asarray(mag))),
                               atol=LOGMEL_TOL)


def test_pqmf_matches_jax_and_torch_reference():
    """The reference's conv pipeline rebuilt with torch ops, JAX's PQMF, and
    the near-perfect reconstruction of a tone mix."""
    import torch.nn.functional as F
    h_a, h_s = filters.pqmf_banks(4, 62, 0.15, 9.0)
    ta = torch.from_numpy(h_a).float().unsqueeze(1)
    ts = torch.from_numpy(h_s).float().unsqueeze(0)
    updown = torch.zeros((4, 4, 4))
    for k in range(4):
        updown[k, k, 0] = 1.
    pad = torch.nn.ConstantPad1d(31, 0.)
    tt = np.arange(22000) / 22050
    sig = sum(np.sin(2 * np.pi * f * tt) for f in (220., 880., 3000.)).astype(np.float32)
    x_t = torch.from_numpy(sig)[None, None]
    bands_t = F.conv1d(F.conv1d(pad(x_t), ta), updown, stride=4)
    rec_t = F.conv1d(pad(F.conv_transpose1d(bands_t, updown * 4, stride=4)), ts)

    pq, jpq = T.PQMF(subbands=4), JT.PQMF(subbands=4)
    bands = pq.analysis(x_t)
    j_bands = jpq.analysis(jnp.asarray(sig)[None, None, :])
    assert bands.shape == (1, 4, 5500)
    np.testing.assert_allclose(bands.numpy(), bands_t.numpy(), atol=PQMF_TOL)
    np.testing.assert_allclose(bands.numpy(), np.asarray(j_bands), atol=PQMF_TOL)
    rec = pq.synthesis(bands)
    np.testing.assert_allclose(rec.numpy(), rec_t.numpy(), atol=PQMF_TOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jpq.synthesis(j_bands)), atol=PQMF_TOL)
    np.testing.assert_allclose(
        pqmf_ops.synthesis(pqmf_ops.analysis(x_t)).numpy(), rec.numpy(), atol=0)
    r = rec.numpy()[0, 0]
    assert np.corrcoef(r[1:20001], sig[:20000])[0, 1] > 0.98
    np.testing.assert_array_equal(T.design_prototype_filter(), JT.design_prototype_filter())


def test_preemphasis_pair(batch_wav):
    x = batch_wav[:, None, :]
    pre = sound_mod.PreEmphasis()(torch.from_numpy(x))
    filt = torch.tensor([[[-0.97, 1.0]]])
    ref = torch.nn.functional.conv1d(
        torch.nn.functional.pad(torch.from_numpy(x), (1, 0), 'reflect'), filt).numpy()
    np.testing.assert_allclose(pre.numpy(), ref, atol=PRE_TOL)
    j_pre = np.asarray(jax_sound_mod.PreEmphasis()(jnp.asarray(x)))
    np.testing.assert_allclose(pre.numpy(), j_pre, atol=PRE_TOL)

    # the inverse from a zero state (its transient decays as 0.97^t)
    rec = sound_mod.InversePreEmphasis()(pre).numpy()
    np.testing.assert_allclose(rec[..., 400:], x[..., 400:], atol=1e-3)
    j_rec = np.asarray(jax.jit(jax_sound_mod.InversePreEmphasis())(jnp.asarray(pre.numpy())))
    exact = scipy.signal.lfilter([1.0], [1.0, -0.97], pre.numpy().astype(np.float64))
    # the port's blocked scan runs in fp64: within PRE_TOL of the exact
    # recurrence; JAX's fp32 associative scan is within PRE_TOL of the peak
    np.testing.assert_allclose(rec, exact, atol=PRE_TOL)
    assert float(np.abs(rec - j_rec).max()) <= PRE_TOL * float(np.abs(exact).max())


@pytest.mark.parametrize('t,coef', [(1, 0.97), (255, 0.97), (257, 0.5), (65537, 0.97),
                                    (300, -0.9)])
def test_inv_preemphasis_blocked_scan(t, coef):
    """Lengths around the scan's block and past two levels of carries, and
    other coefficients, against the recurrence in fp64."""
    x = np.random.default_rng(t).standard_normal((3, t))
    y = sound_ops.inv_preemphasis(torch.from_numpy(x), coef).numpy()
    np.testing.assert_allclose(y, scipy.signal.lfilter([1.0], [1.0, -coef], x), atol=1e-12)


def test_vol_norm_conv_matches_jax(batch_wav):
    vn, jvn = (sound_mod.VolNormConv(1024, 256, -11.5),
               jax_sound_mod.VolNormConv(1024, 256, -11.5))
    normed, j_normed = vn.forward(torch.from_numpy(batch_wav)), jvn.forward(jnp.asarray(batch_wav))
    assert normed.shape == j_normed.shape
    np.testing.assert_allclose(vn.std_buffer.numpy(), np.asarray(jvn.std_buffer), rtol=1e-4)
    np.testing.assert_allclose(normed.numpy(), np.asarray(j_normed), rtol=1e-4, atol=1e-5)
    rec = vn.reverse(normed).numpy()
    np.testing.assert_allclose(rec, batch_wav[:, :rec.shape[-1]], atol=1e-4)


def test_multi_stft_loss_matches_jax(batch_wav):
    params = [(1024, 1024, 256), (512, 512, 128)]
    x = torch.from_numpy(batch_wav)
    total, _, _ = sound_mod.multi_stft_loss(x, x, params)
    assert float(total) < 1e-5
    y = batch_wav + 0.1 * np.sin(np.arange(batch_wav.shape[-1]) * 0.01).astype(np.float32)
    got = sound_ops.multi_stft_loss(torch.from_numpy(y), x, params)
    ref = jax.jit(lambda p, t: jax_sound.multi_stft_loss(p, t, params))(
        jnp.asarray(y), jnp.asarray(batch_wav))
    assert float(got[0]) > float(total)
    assert np.isclose(float(got[0]), float(got[1]) + float(got[2]), atol=1e-6)
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in ref], rtol=1e-5)
    assert [type(f) for f in sound_mod.build_stft_functions((1024, 1024, 256))] == [T.STFTTorchAudio]


def test_spectrogram_masker_matches_jax():
    for mask in (np.ones((2, 2560), np.float32),
                 np.concatenate([np.ones((1, 1280)), np.zeros((1, 1280))], 1).astype(np.float32)):
        out = T.SpectrogramMasker(WIN, HOP)(torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(out, np.asarray(JT.SpectrogramMasker(WIN, HOP)(
            jnp.asarray(mask))))
        assert out.shape == (mask.shape[0], 2560 // HOP + 1) and out[0, 0] == 1.0
    assert out[0, -1] == 0.0


def test_stft_batch_matches_items(batch_wav):
    """The counterpart of JAX's jit / vmap case: a batch's magnitude is its
    items', and the torchaudio-style STFT round trip and transform match
    JAX's."""
    x = torch.from_numpy(batch_wav)
    out = stft_ops.spectrogram_magnitude(x, N_FFT, HOP, WIN)
    assert out.shape == (2, 513, 87)
    items = torch.stack([stft_ops.spectrogram_magnitude(w, N_FFT, HOP, WIN) for w in x])
    np.testing.assert_allclose(out.numpy(), items.numpy(), atol=1e-5)
    st, jst = T.STFTTorchAudio(WIN, HOP), JT.STFTTorchAudio(WIN, HOP)
    mag, phase = st.transform(x)
    j_mag, j_phase = jst.transform(jnp.asarray(batch_wav))
    close_to_peak(mag, j_mag)
    rec = st.inverse(mag, phase).numpy()
    np.testing.assert_allclose(rec, np.asarray(jst.inverse(j_mag, j_phase)), atol=1e-5)
    np.testing.assert_allclose(rec, batch_wav[:, :rec.shape[-1]], atol=1e-4)


def test_device_constant_cache_is_bounded():
    """device_constant copies an array once per (device, dtype) and reuses
    the copy; it keeps the most recently used 64 and releases the rest, so a
    dropped array is no longer held."""
    import gc
    import weakref
    from pytorch_sound_tpu_torch.utils import tensor as tensor_utils
    like32, like64 = torch.zeros(1), torch.zeros(1, dtype=torch.float64)
    kept = np.arange(4.0)
    first = tensor_utils.device_constant(kept, like32)
    assert first.dtype == torch.float32 and torch.equal(first, torch.arange(4.0))
    assert tensor_utils.device_constant(kept, like32) is first
    assert tensor_utils.device_constant(kept, like64).dtype == torch.float64
    dropped = np.ones(3)
    ref = weakref.ref(dropped)
    tensor_utils.device_constant(dropped, like32)
    arrays = [np.full(2, float(i)) for i in range(tensor_utils._MAX_CONSTANTS)]
    for i, a in enumerate(arrays):
        tensor_utils.device_constant(a, like32)
        if i % 8 == 0:      # kept in use: stays while the others pass through
            assert tensor_utils.device_constant(kept, like32) is first
    assert len(tensor_utils._CONSTANTS) == tensor_utils._MAX_CONSTANTS
    del dropped
    gc.collect()
    assert ref() is None
    assert tensor_utils.device_constant(kept, like32) is first


def test_learnable_stft_matches_jax(batch_wav):
    """At its initial bases LearnableSTFT is the fixed conv STFT; bases carried
    over from a JAX parameter tree (perturbed) give JAX's outputs; gradients
    reach both bases. At 512 / 128, as the conv STFT's case."""
    m = T.LearnableSTFT(filter_length=512, hop_length=128)
    x = torch.from_numpy(batch_wav)
    mag, phase = m(x)
    ref_mag, _ = T.STFT(filter_length=512, hop_length=128).transform(x)
    close_to_peak(mag.detach(), ref_mag)
    rec = m.inverse(mag, phase)
    np.testing.assert_allclose(rec.detach().numpy(), batch_wav[:, :rec.shape[-1]], atol=1e-3)

    jm = JT.LearnableSTFT(filter_length=512, hop_length=128)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), batch_wav))
    for name in ('forward_basis', 'inverse_basis'):
        np.testing.assert_array_equal(getattr(m, name).detach().numpy(), tree['params'][name])
    rng = np.random.default_rng(1)
    tree = {'params': {k: v * (1 + 0.01 * rng.standard_normal(v.shape)).astype(np.float32)
                       for k, v in tree['params'].items()}}
    mc = T.learnable_stft_from_jax(tree, 128)
    mag, phase = mc(x)
    j_mag, j_phase = jm.apply(tree, jnp.asarray(batch_wav))
    close_to_peak(mag.detach(), j_mag)
    rec = mc.inverse(mag, phase)
    j_rec = jm.apply(tree, j_mag, j_phase, method=JT.LearnableSTFT.inverse)
    np.testing.assert_allclose(rec.detach().numpy(), np.asarray(j_rec), atol=1e-4)
    rec.square().mean().backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0) for p in mc.parameters())
    assert {n for n, _ in mc.named_parameters()} == {'forward_basis', 'inverse_basis'}


def test_mulaw_matches_jax(batch_wav):
    x = np.tanh(batch_wav)
    q = sound_ops.mulaw_encode(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jax_sound.mulaw_encode(jnp.asarray(x))))
    assert int(q.min()) >= 0 and int(q.max()) <= 255 and q.dtype == torch.int32
    back = sound_ops.mulaw_decode(q, 256)
    assert float((back - torch.from_numpy(x)).abs().max()) < 0.04
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_sound.mulaw_decode(
        jnp.asarray(q.numpy()))), atol=1e-6)


def _htk_fbank_pointwise(sr, n_fft, n_mels, f_min, f_max):
    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    all_freqs = np.linspace(0, sr // 2, n_fft // 2 + 1)
    f_pts = [mel2hz(m) for m in np.linspace(hz2mel(f_min), hz2mel(f_max), n_mels + 2)]
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, ctr, hi = f_pts[i], f_pts[i + 1], f_pts[i + 2]
        for k, f in enumerate(all_freqs):
            fb[i, k] = max(0.0, min((f - lo) / (ctr - lo), (hi - f) / (hi - ctr)))
    return fb


def test_logmel_torchaudio_htk_matches_jax_and_formula(batch_wav):
    spec = torch_stft(batch_wav)
    power = (spec.real ** 2 + spec.imag ** 2).numpy()
    fb = _htk_fbank_pointwise(s.SAMPLE_RATE, N_FFT, s.MEL_SIZE, s.MEL_MIN, s.MEL_MAX)
    np.testing.assert_allclose(
        filters.mel_filterbank(22050, 1024, 80, 0.0, 8000.0, htk=True, norm=None),
        fb, atol=1e-10)
    lo, hi = mel_ops.db_to_log(s.MIN_DB), mel_ops.db_to_log(s.MAX_DB)
    ref = np.log(fb @ power + 1e-6).clip(lo, hi)
    args = (s.SAMPLE_RATE, s.MEL_SIZE, N_FFT, WIN, HOP, s.MIN_DB, s.MAX_DB, s.MEL_MIN,
            s.MEL_MAX)
    mel = T.LogMelSpectrogramTorchAudio(*args)(torch.from_numpy(batch_wav)).numpy()
    np.testing.assert_allclose(mel, ref, atol=2e-3)
    np.testing.assert_allclose(
        mel, np.asarray(JT.LogMelSpectrogramTorchAudio(*args)(jnp.asarray(batch_wav))),
        atol=LOGMEL_TOL)
