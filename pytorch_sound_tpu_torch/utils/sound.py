"""Host-side sound utilities: the port's copy of
``pytorch_sound_tpu/utils/sound.py::get_wav_duration``. The rest of that
module (midi, filters, f0, pre-emphasis) is not ported yet."""

import struct

from pytorch_sound_tpu_torch.utils.wavio import read_wav_info


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
