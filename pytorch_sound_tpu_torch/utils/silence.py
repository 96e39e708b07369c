"""RMS-based silence detection and splitting on numpy arrays: the port's copy
of ``pytorch_sound_tpu/utils/silence.py`` (pydub's semantics, with a
cumulative-sum sliding RMS: a span is silent when the RMS of every
``min_silence_len`` window inside it is <= the threshold).
"""

import numpy as np


def rms(x: np.ndarray) -> float:
    """Root-mean-square of an array."""
    x = np.asarray(x)
    if x.size == 0:
        return 0.0
    return float(np.sqrt(x.dot(x) / x.size))


def db_to_float(db: float, using_amplitude: bool = True) -> float:
    """dB -> linear ratio (amplitude by default, power otherwise)."""
    db = float(db)
    return 10 ** (db / 20) if using_amplitude else 10 ** (db / 10)


def _sliding_rms(x: np.ndarray, window: int, step: int) -> np.ndarray:
    """RMS of every window start in range(0, len(x)-window+1, step), via cumsum."""
    sq = np.concatenate([[0.0], np.cumsum(np.square(x, dtype=np.float64))])
    starts = np.arange(0, len(x) - window + 1, step)
    return np.sqrt((sq[starts + window] - sq[starts]) / window)


def detect_silence(audio_segment: np.ndarray, min_silence_len: int = 1000,
                   silence_thresh: float = -16, seek_step: int = 1):
    """Return [start, end] sample ranges whose every window is below threshold."""
    seg_len = len(audio_segment)
    if seg_len < min_silence_len:
        return []

    thresh = db_to_float(silence_thresh)
    last_slice_start = seg_len - min_silence_len

    window_rms = _sliding_rms(audio_segment, min_silence_len, seek_step)
    starts = list(np.arange(0, last_slice_start + 1, seek_step)[window_rms <= thresh])
    # guarantee the final window is checked (tail coverage)
    if last_slice_start % seek_step:
        if rms(audio_segment[last_slice_start:]) <= thresh:
            starts.append(last_slice_start)

    if not starts:
        return []

    # merge window starts into contiguous silent ranges
    silent_ranges = []
    prev_i = starts[0]
    current_range_start = prev_i
    for start_i in starts[1:]:
        continuous = (start_i == prev_i + seek_step)
        has_gap = start_i > (prev_i + min_silence_len)
        if not continuous and has_gap:
            silent_ranges.append([current_range_start, prev_i + min_silence_len])
            current_range_start = start_i
        prev_i = start_i
    silent_ranges.append([current_range_start, prev_i + min_silence_len])
    return silent_ranges


def detect_nonsilent(audio_segment: np.ndarray, min_silence_len: int = 1000,
                     silence_thresh: float = -16, seek_step: int = 1):
    """Complement of :func:`detect_silence` over the segment."""
    silent_ranges = detect_silence(audio_segment, min_silence_len, silence_thresh, seek_step)
    len_seg = len(audio_segment)

    if not silent_ranges:
        return [[0, len_seg]]
    if silent_ranges[0][0] == 0 and silent_ranges[0][1] == len_seg:
        return []

    prev_end_i = 0
    nonsilent_ranges = []
    for start_i, end_i in silent_ranges:
        nonsilent_ranges.append([prev_end_i, start_i])
        prev_end_i = end_i
    if end_i != len_seg:
        nonsilent_ranges.append([prev_end_i, len_seg])
    if nonsilent_ranges[0] == [0, 0]:
        nonsilent_ranges.pop(0)
    return nonsilent_ranges


def split_on_silence(audio_segment: np.ndarray, min_silence_len: int = 1000,
                     silence_thresh: float = -16, keep_silence: int = 100,
                     seek_step: int = 1):
    """Split an array at silent spans, keeping ``keep_silence`` samples of
    padding at each chunk boundary."""
    not_silence_ranges = detect_nonsilent(
        audio_segment, min_silence_len, silence_thresh, seek_step)
    chunks = []
    for start_i, end_i in not_silence_ranges:
        start_i = max(0, start_i - keep_silence)
        end_i += keep_silence
        chunks.append(audio_segment[start_i:end_i])
    return chunks
