"""English text <-> index codecs: the port's copy of the English half of
``pytorch_sound_tpu/utils/text.py``. The Korean codecs (``kor_*``) wait for
the Korean G2P."""

from typing import List

import numpy as np

from pytorch_sound_tpu_torch import settings
from pytorch_sound_tpu_torch.data.eng_handler import sequence_to_text, text_to_sequence


def eng_c2i(sentence: str) -> List[int]:
    """English characters -> indices (unknown characters dropped)."""
    return [settings.ENG_TO_IDX[c] for c in sentence if c in settings.ENG_TO_IDX]


def eng_i2c(idx: List[int]) -> List[str]:
    """Indices -> English characters (out-of-range dropped)."""
    return [settings.IDX_TO_ENG[i] for i in idx if 0 < i < len(settings.IDX_TO_ENG)]


def eng_t2i(txt: str) -> np.ndarray:
    """Raw English text -> cleaned index array with EOS appended."""
    return pad_eng_eos(text_to_sequence(txt, ['english_cleaners']))


def eng_i2t(ixs: List[int]) -> str:
    """Index sequence -> English text."""
    return sequence_to_text(ixs)


def pad_eng_eos(x) -> np.ndarray:
    """Append the English EOS id (== vocab size)."""
    return np.array(list(x) + [settings.ENG_VOCA_SIZE])
