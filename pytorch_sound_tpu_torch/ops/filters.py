"""Filterbanks, windows, DFT and DCT bases, PQMF banks (host-side numpy
constants).

Counterpart of ``pytorch_sound_tpu/ops/filters.py``, copied so that the port
runs without the JAX package installed. The formulas are the JAX package's
own (librosa's Slaney filterbank, scipy's windows, torchaudio's DCT-II, the
Kaiser PQMF prototype); ``tests/test_torch_mel.py`` and
``tests/test_torch_dsp.py`` hold the two bit-equal. All functions return
float64 numpy; cast at use site.
"""

from typing import Optional

import numpy as np


def get_window(*args, **kwargs) -> np.ndarray:
    """``scipy.signal.get_window``, imported at the first call: scipy.signal
    takes seconds to import, which every process of the port would pay."""
    from scipy.signal import get_window as scipy_get_window
    return scipy_get_window(*args, **kwargs)


def hz_to_mel_slaney(f):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    log_region = f >= 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep, mel)


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    log_region = m >= 15.0
    logstep = np.log(6.4) / 27.0
    return np.where(log_region, 1000.0 * np.exp(logstep * (m - 15.0)), f)


def hz_to_mel_htk(f):
    """HTK mel scale: 2595 * log10(1 + f/700)."""
    f = np.asarray(f, dtype=np.float64)
    return 2595.0 * np.log10(1.0 + f / 700.0)


def mel_to_hz_htk(m):
    m = np.asarray(m, dtype=np.float64)
    return 700.0 * (np.power(10.0, m / 2595.0) - 1.0)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False, norm: Optional[str] = 'slaney') -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft//2); the defaults
    match librosa.filters.mel (Slaney scale, Slaney area norm)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    hz_to_mel = hz_to_mel_htk if htk else hz_to_mel_slaney
    mel_to_hz = mel_to_hz_htk if htk else mel_to_hz_slaney

    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == 'slaney':
        weights *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    elif norm is not None:
        raise ValueError("norm must be None or 'slaney'")
    return weights


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window; ``periodic=True`` matches torch.hann_window."""
    return get_window('hann', win_length, fftbins=periodic).astype(np.float64)


def get_window_array(window, win_length: int, periodic: bool = True) -> np.ndarray:
    """scipy.signal.get_window for any window name or (name, param) tuple."""
    return get_window(window, win_length, fftbins=periodic).astype(np.float64)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to ``size`` (librosa.util.pad_center)."""
    n = len(window)
    lpad = (size - n) // 2
    return np.pad(window, (lpad, size - n - lpad))


def dft_basis(n_fft: int) -> np.ndarray:
    """Stacked real DFT basis, (2 * (n_fft//2 + 1), n_fft): rows 0..cutoff are
    cos(2πkn/N), rows cutoff.. are -sin(2πkn/N) (numpy's sign convention)."""
    cutoff = n_fft // 2 + 1
    k = np.arange(cutoff)[:, None]
    n = np.arange(n_fft)[None, :]
    angle = 2.0 * np.pi * k * n / n_fft
    return np.vstack([np.cos(angle), -np.sin(angle)])


def stft_basis(n_fft: int, win_length: Optional[int] = None,
               window='hann') -> np.ndarray:
    """Windowed forward STFT basis (2 * cutoff, n_fft): :func:`dft_basis`
    times the centered window."""
    win_length = win_length or n_fft
    assert n_fft >= win_length
    win = pad_center(get_window(window, win_length, fftbins=True), n_fft)
    return dft_basis(n_fft) * win[None, :]


def istft_pinv_basis(n_fft: int, hop_length: int, win_length: Optional[int] = None,
                     window='hann') -> np.ndarray:
    """Inverse basis of the conv-basis STFT: pinv(n_fft / hop * dft_basis).T
    times the centered window, (2 * cutoff, n_fft)."""
    win_length = win_length or n_fft
    win = pad_center(get_window(window, win_length, fftbins=True), n_fft)
    scaled = (n_fft / hop_length) * dft_basis(n_fft)
    inv = np.linalg.pinv(scaled).T
    return inv * win[None, :]


def dct_matrix(n_mfcc: int, n_mels: int, norm: Optional[str] = 'ortho') -> np.ndarray:
    """DCT-II matrix (n_mfcc, n_mels): ``D @ mel`` gives MFCCs
    (torchaudio.functional.create_dct(n_mfcc, n_mels, norm).T)."""
    n = np.arange(n_mels)[None, :]
    k = np.arange(n_mfcc)[:, None]
    dct = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_mels))
    if norm == 'ortho':
        dct[0] *= 1.0 / np.sqrt(2.0)
        dct *= np.sqrt(1.0 / (2.0 * n_mels))
    elif norm is not None:
        raise ValueError('norm must be None or ortho')
    return dct


def pqmf_prototype(taps: int = 62, cutoff_ratio: float = 0.15,
                   beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed lowpass prototype filter of the PQMF, taps + 1 long."""
    assert taps % 2 == 0, 'The number of taps must be even.'
    assert 0.0 < cutoff_ratio < 1.0
    omega_c = np.pi * cutoff_ratio
    with np.errstate(invalid='ignore'):
        t = np.arange(taps + 1) - 0.5 * taps
        h_i = np.sin(omega_c * t) / (np.pi * t)
    h_i[taps // 2] = cutoff_ratio    # the limit at t = 0
    from scipy.signal.windows import kaiser
    return h_i * kaiser(taps + 1, beta)


def pqmf_banks(subbands: int = 4, taps: int = 62, cutoff_ratio: float = 0.15,
               beta: float = 9.0):
    """Cosine-modulated analysis and synthesis banks, each (subbands, taps + 1)."""
    h_proto = pqmf_prototype(taps, cutoff_ratio, beta)
    t = np.arange(taps + 1) - (taps - 1) / 2.0
    k = np.arange(subbands)[:, None]
    phase = (2 * k + 1) * (np.pi / (2 * subbands)) * t[None, :]
    sign = ((-1.0) ** k) * np.pi / 4.0
    h_analysis = 2.0 * h_proto[None, :] * np.cos(phase + sign)
    h_synthesis = 2.0 * h_proto[None, :] * np.cos(phase - sign)
    return h_analysis, h_synthesis
