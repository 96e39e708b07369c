"""Host-side sound utilities: the port's copy of
``pytorch_sound_tpu/utils/sound.py``, numpy and scipy code (scipy imported
where a function uses it): the MIDI reader's entry point, a zero-phase
Butterworth low-pass, two f0 trackers (YIN and a DIO + StoneMask style one),
wav durations from the header, and the pre-emphasis pair."""

import struct
import warnings

import numpy as np

from pytorch_sound_tpu_torch.utils.midi import MidiFile
from pytorch_sound_tpu_torch.utils.wavio import read_wav_info


def parse_midi(path: str) -> MidiFile:
    """Parse a MIDI file into a :class:`MidiFile` (piano-roll capable), its
    notes that end before they start removed; a file that cannot be read
    raises ValueError naming it."""
    try:
        midi = MidiFile(path)
        midi.remove_invalid_notes()
    except (OSError, ValueError, NotImplementedError, IndexError, struct.error) as e:
        raise ValueError('%s\nerror reading midi file %s' % (e, path)) from e
    return midi


def lowpass(wav: np.ndarray, frequency: int, sr: int = 22050, order: int = 5) -> np.ndarray:
    """Low-pass filter (Butterworth, zero-phase).

    The JAX package's filter (the upstream project shelled out to sox).
    """
    from scipy import signal
    nyq = sr / 2
    sos = signal.butter(order, min(frequency / nyq, 0.999), btype='low', output='sos')
    return signal.sosfiltfilt(sos, wav).astype(np.float32)


def get_f0(wav: np.ndarray, hop_length: int, sr: int = 22050,
           fmin: float = 60.0, fmax: float = 500.0,
           threshold: float = 0.15) -> np.ndarray:
    """Frame-wise f0: YIN-style cumulative-mean-normalized difference tracker.

    The upstream project used WORLD's dio + stonemask (pyworld); this is the
    JAX package's independent implementation of the published
    YIN estimator (difference function -> CMNDF -> absolute threshold with
    local-minimum selection -> parabolic refinement -> median de-glitch) with
    the same output contract: one f0 value per hop, 0 for unvoiced frames,
    float32. Accuracy is gated by synthetic-sweep tests
    (tests/test_utils.py::test_get_f0_*): < 1% error on stationary tones and
    glissandi within [fmin, fmax].

    All frames are processed vectorized: the difference function d(tau) is
    computed for every frame at once via row-wise FFT cross-correlation plus
    rolling energy sums.
    """
    from scipy import signal
    x = np.asarray(wav, dtype=np.float64)
    n_frames = max(1, int(np.ceil(len(x) / hop_length)))

    lag_min = max(2, int(sr / fmax))
    lag_max = int(np.ceil(sr / fmin))
    win = 2 * lag_max                      # integration window W
    total = win + lag_max                  # window + max lag lookahead

    pad_left = win // 2
    pad_right = (n_frames - 1) * hop_length + total - len(x) + pad_left
    mode = 'reflect' if len(x) > 1 else 'constant'
    x = np.pad(x, (pad_left, max(0, pad_right)), mode=mode)

    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(total)[None, :]
    frames = x[idx]                        # (N, total)
    head = frames[:, :win]                 # (N, W)

    # cross[n, tau] = sum_j head[n, j] * frames[n, j + tau],  tau = 0..lag_max
    cross = signal.fftconvolve(frames, head[:, ::-1], mode='valid', axes=1)
    sq = frames * frames
    csum = np.concatenate([np.zeros((n_frames, 1)), np.cumsum(sq, axis=1)], axis=1)
    e0 = csum[:, win] - csum[:, 0]                               # (N,)
    taus = np.arange(lag_max + 1)
    e_tau = csum[:, taus + win] - csum[:, taus]                  # (N, lag_max+1)
    diff = np.maximum(e0[:, None] + e_tau - 2.0 * cross, 0.0)    # d(tau)

    # cumulative mean normalized difference: d'(0)=1, d'(t)=d(t)*t/sum_{1..t} d
    run = np.cumsum(diff[:, 1:], axis=1)
    cmndf = np.ones_like(diff)
    cmndf[:, 1:] = diff[:, 1:] * taus[1:][None, :] / np.maximum(run, 1e-12)

    # first local minimum below threshold within [lag_min, lag_max); fallback
    # to the global CMNDF minimum of that range
    seg = cmndf[:, lag_min:lag_max]
    nxt = cmndf[:, lag_min + 1:lag_max + 1]
    hit = (seg < threshold) & (seg <= nxt)
    has_hit = hit.any(axis=1)
    first = np.where(has_hit, hit.argmax(axis=1), seg.argmin(axis=1)) + lag_min

    rows = np.arange(n_frames)
    d_min = cmndf[rows, first]

    # parabolic interpolation around the minimum
    left = cmndf[rows, np.maximum(first - 1, 0)]
    right = cmndf[rows, np.minimum(first + 1, lag_max)]
    denom = left - 2.0 * d_min + right
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (left - right) / np.where(
        np.abs(denom) > 1e-12, denom, 1.0), 0.0)
    shift = np.clip(shift, -0.5, 0.5)

    voiced = (d_min < 0.3) & (e0 > 1e-9)
    f0 = np.where(voiced, sr / (first + shift), 0.0)

    # 3-point median filter on voiced runs removes isolated octave glitches
    if n_frames >= 3:
        med = np.copy(f0)
        stack = np.stack([f0[:-2], f0[1:-1], f0[2:]])
        med[1:-1] = np.where(f0[1:-1] > 0, np.median(stack, axis=0), 0.0)
        f0 = med
    return f0.astype(np.float32)


def _event_freq_track(y: np.ndarray, sr: float, frame_times: np.ndarray,
                      kind: str) -> np.ndarray:
    """Interval-based frequency track from one event type of a (near-)sine.

    ``kind``: 'rising'/'falling' zero crossings (sub-sample by linear
    interpolation) or 'peak'/'dip' extrema. Consecutive event intervals give
    local frequency estimates at interval midpoints, interpolated to
    ``frame_times``. NaN where fewer than 2 events exist.
    """
    if kind in ('rising', 'falling'):
        s = y if kind == 'rising' else -y
        pos = s > 0
        i = np.nonzero(~pos[:-1] & pos[1:])[0]
        if len(i) < 2:
            return np.full(len(frame_times), np.nan)
        frac = s[i] / (s[i] - s[i + 1])
        times = (i + frac) / sr
    else:
        s = y if kind == 'peak' else -y
        i = np.nonzero((s[1:-1] > s[:-2]) & (s[1:-1] >= s[2:]))[0] + 1
        if len(i) < 2:
            return np.full(len(frame_times), np.nan)
        # parabolic sub-sample peak refinement
        denom = s[i - 1] - 2.0 * s[i] + s[i + 1]
        shift = np.where(np.abs(denom) > 1e-12,
                         0.5 * (s[i - 1] - s[i + 1]) / np.where(
                             np.abs(denom) > 1e-12, denom, 1.0), 0.0)
        times = (i + np.clip(shift, -0.5, 0.5)) / sr
    freqs = 1.0 / np.maximum(np.diff(times), 1e-9)
    mids = 0.5 * (times[:-1] + times[1:])
    return np.interp(frame_times, mids, freqs, left=np.nan, right=np.nan)


def _instantaneous_frequency(x: np.ndarray, sr: float, centers: np.ndarray,
                             f0: np.ndarray):
    """StoneMask-style refinement: per frame, the instantaneous frequency of
    the fundamental from the phase advance of a windowed DFT bin at ``f0``
    between two one-sample-shifted analysis windows (3 periods, hann).

    Also returns the fundamental's *salience* — the estimated sine amplitude
    at f0 over the segment RMS (≈1 for a pure tone, ≈0 for noise) — used as
    a harmonicity voicing gate: band-filtered noise fools interval analysis
    (it becomes narrowband, hence quasi-sinusoidal) but holds almost no raw
    energy at any single frequency."""
    out = f0.copy()
    salience = np.zeros_like(f0)
    n = len(x)
    for t, (c, f) in enumerate(zip(centers, f0)):
        if f <= 0:
            continue
        half = int(1.5 * sr / f)
        lo, hi = int(c) - half, int(c) + half + 1
        if lo < 0 or hi + 1 > n:
            salience[t] = 1.0        # edge frame: keep the band decision
            continue
        seg = x[lo:hi]
        w = np.hanning(len(seg))
        ph = np.exp(-2j * np.pi * f * (np.arange(len(seg)) / sr))
        x1 = np.sum(seg * w * ph)
        x2 = np.sum(x[lo + 1:hi + 1] * w * ph)
        rms = np.sqrt(np.mean(seg * seg)) + 1e-12
        amp = 2.0 * abs(x1) / max(np.sum(w), 1e-12)
        salience[t] = amp / (rms * np.sqrt(2.0))
        if abs(x1) < 1e-12 or abs(x2) < 1e-12:
            continue
        adv = np.angle(x2 * np.conj(x1))      # phase advance per sample
        f_if = adv * sr / (2.0 * np.pi)
        if 0.5 * f < f_if < 2.0 * f:
            out[t] = f_if
    return out, salience


def get_f0_dio(wav: np.ndarray, hop_length: int, sr: int = 22050,
               fmin: float = 60.0, fmax: float = 500.0,
               reliability_threshold: float = 0.12) -> np.ndarray:
    """Frame-wise f0 in the style of WORLD's dio + stonemask.

    The upstream project calls pyworld's dio + stonemask; this is the JAX
    package's independent implementation of the published
    DIO recipe (Morise 2009): half-octave-spaced candidate bands, each
    low-passed so a matching fundamental becomes a near-sine; four
    interval-based frequency tracks per band (rising/falling zero crossings,
    peaks, dips); the band whose four tracks agree best wins, with the
    normalized disagreement as the voicing decision; a stonemask-style
    instantaneous-frequency refinement sharpens each voiced frame. Output
    contract matches :func:`get_f0`: one float32 f0 per hop, 0 = unvoiced.
    """
    from scipy import signal
    x = np.asarray(wav, dtype=np.float64)
    n_frames = max(1, int(np.ceil(len(x) / hop_length)))
    frame_times = np.arange(n_frames) * (hop_length / sr)

    # half-octave candidate grid covering [fmin, fmax]
    n_bands = max(2, int(np.ceil(2.0 * np.log2(fmax / fmin))) + 1)
    bands = fmin * (2.0 ** (0.5 * np.arange(n_bands)))
    bands = bands[bands <= fmax * np.sqrt(2.0)]

    nyq = sr / 2.0
    best_f0 = np.zeros(n_frames)
    best_rel = np.full(n_frames, np.inf)
    for fc in bands:
        # low-pass at ~1.2*fc: a fundamental near fc survives as a near-sine
        sos = signal.butter(4, min(1.2 * fc / nyq, 0.999), btype='low',
                            output='sos')
        y = signal.sosfiltfilt(sos, x)
        tracks = np.stack([
            _event_freq_track(y, sr, frame_times, kind)
            for kind in ('rising', 'falling', 'peak', 'dip')])
        with warnings.catch_warnings():
            # frames where all four tracks are NaN are expected; they are
            # rejected by the `ok` mask below
            warnings.simplefilter('ignore', RuntimeWarning)
            mean4 = np.nanmean(tracks, axis=0)
            std4 = np.nanstd(tracks, axis=0)
        ok = (~np.isnan(mean4) & (~np.isnan(tracks).any(axis=0))
              & (mean4 >= fc / np.sqrt(2.0)) & (mean4 <= fc * np.sqrt(2.0))
              & (mean4 >= fmin) & (mean4 <= fmax))
        rel = np.where(ok, std4 / np.maximum(mean4, 1e-9), np.inf)
        better = rel < best_rel
        best_rel = np.where(better, rel, best_rel)
        best_f0 = np.where(better, mean4, best_f0)

    voiced = best_rel < reliability_threshold
    f0 = np.where(voiced, best_f0, 0.0)

    centers = np.minimum(np.arange(n_frames) * hop_length, len(x) - 1)
    f0, salience = _instantaneous_frequency(x, sr, centers, f0)
    f0 = np.where(salience > 0.25, f0, 0.0)

    if n_frames >= 3:        # de-glitch as in get_f0
        med = np.copy(f0)
        stack = np.stack([f0[:-2], f0[1:-1], f0[2:]])
        med[1:-1] = np.where(f0[1:-1] > 0, np.median(stack, axis=0), 0.0)
        f0 = med
    return f0.astype(np.float32)


def get_wav_duration(file: str) -> float:
    """Duration of a wav file in seconds from its header alone; -1 where
    the header cannot be read (no path, a missing, foreign or truncated
    file, a zero rate), which drops the row from a meta."""
    try:
        sr, n_frames, _, _ = read_wav_info(file)
        dur = n_frames / sr
    except (OSError, TypeError, ValueError, struct.error, ZeroDivisionError):
        dur = -1
    return dur


def preemphasis(x: np.ndarray, coeff: float = 0.97) -> np.ndarray:
    """First-order FIR pre-emphasis: y[t] = x[t] - coeff*x[t-1]."""
    from scipy import signal
    return signal.lfilter([1, -coeff], [1], x).astype(np.float32)


def inv_preemphasis(x: np.ndarray, coeff: float = 0.97) -> np.ndarray:
    """Inverse (IIR) of :func:`preemphasis`."""
    from scipy import signal
    return signal.lfilter([1], [1, -coeff], x).astype(np.float32)
