"""Text <-> index codecs for English characters and Korean phonemes /
graphemes: the port's copy of ``pytorch_sound_tpu/utils/text.py``."""

import unicodedata
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


def kor_p2i(phonemes: str) -> List[int]:
    """Space-separated Korean phonemes -> indices."""
    return [settings.KOR_PHN_TO_IDX[p] for p in phonemes.split() if p in settings.KOR_PHN_TO_IDX]


def kor_i2p(idx: List[int]) -> List[str]:
    """Indices -> Korean phonemes."""
    return [settings.IDX_TO_KOR_PHN[i] for i in idx if i < len(settings.IDX_TO_KOR_PHN)]


def pad_korp_eos(x) -> np.ndarray:
    """Append the Korean phoneme EOS id."""
    return np.array(list(x) + [settings.KOR_PHN_SIZE])


def kor_g2i(graphemes: str) -> List[int]:
    """Korean (NFD-decomposed) graphemes -> indices."""
    return [settings.KOR_GRP_TO_IDX[g] for g in graphemes if g in settings.KOR_GRP_TO_IDX]


def kor_i2g(idx: List[int]) -> List[str]:
    """Indices -> Korean graphemes."""
    return [settings.IDX_TO_KOR_GRP[i] for i in idx if i < len(settings.IDX_TO_KOR_GRP)]


def pad_korg_eos(x) -> np.ndarray:
    """Append the Korean grapheme EOS id."""
    return np.array(list(x) + [settings.KOR_GRP_SIZE])


def kor_text2grp(text: str) -> str:
    """Decompose precomposed Hangul into jamo graphemes (NFD)."""
    return unicodedata.normalize('NFD', text)


def kor_grp2text(grp: str) -> str:
    """Recompose jamo graphemes into Hangul syllables (NFC)."""
    return unicodedata.normalize('NFC', grp)
