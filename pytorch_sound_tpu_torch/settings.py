"""Global audio/STFT configuration and text vocabularies.

The port's copy of ``pytorch_sound_tpu/settings.py``, same values: the
22.05 kHz / 1024-point / hop-256 / 80-mel signal chain every transform,
preprocess pipeline and golden test in this toolkit is pinned to.

Structure: the audio chain lives in a frozen :class:`AudioConfig` dataclass
(immutable and hashable); the module-level constant names are re-exported
from the default instance.
"""

import multiprocessing
from dataclasses import asdict, dataclass
from typing import Dict, List

from pytorch_sound_tpu_torch.data.eng_handler.symbols import symbols as _eng_symbols
from pytorch_sound_tpu_torch.data.korean import GRAPHEMES as _kor_graphemes
from pytorch_sound_tpu_torch.data.korean import PHONEMES as _kor_phonemes


@dataclass(frozen=True)
class AudioConfig:
    """The default signal chain (immutable, hashable)."""

    sample_rate: int = 22050
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    mel_size: int = 80
    mfcc_size: int = 40
    mel_min: int = 0          # mel filterbank lower frequency bound (Hz)
    mel_max: int = 8000       # mel filterbank upper frequency bound (Hz)
    min_db: int = -50         # log-mel clamp floor (dB)
    max_db: int = 30          # log-mel clamp ceiling (dB)
    vn_db: float = -11.5      # volume-normalization target (dB)
    mulaw_bins: int = 256     # mu-law quantization levels

    @property
    def hop_stride(self) -> int:
        """Frames per analysis window."""
        return self.win_length // self.hop_length

    @property
    def spec_size(self) -> int:
        """One-sided spectrogram bin count."""
        return self.win_length // 2 + 1

    def as_dict(self) -> dict:
        return asdict(self)


DEFAULT_AUDIO_CONFIG = AudioConfig()


def _index_map(symbol_table: List[str]) -> Dict[str, int]:
    """symbol -> 1-based index (0 is reserved for padding)."""
    return {sym: i + 1 for i, sym in enumerate(symbol_table[1:])}


# -- module-level constants (reference-compatible names) ---------------------

SAMPLE_RATE: int = DEFAULT_AUDIO_CONFIG.sample_rate
N_FFT: int = DEFAULT_AUDIO_CONFIG.n_fft
WIN_LENGTH: int = DEFAULT_AUDIO_CONFIG.win_length
HOP_LENGTH: int = DEFAULT_AUDIO_CONFIG.hop_length
HOP_STRIDE: int = DEFAULT_AUDIO_CONFIG.hop_stride
SPEC_SIZE: int = DEFAULT_AUDIO_CONFIG.spec_size
MEL_SIZE: int = DEFAULT_AUDIO_CONFIG.mel_size
MFCC_SIZE: int = DEFAULT_AUDIO_CONFIG.mfcc_size
MEL_MIN: int = DEFAULT_AUDIO_CONFIG.mel_min
MEL_MAX: int = DEFAULT_AUDIO_CONFIG.mel_max
MIN_DB: int = DEFAULT_AUDIO_CONFIG.min_db
MAX_DB: int = DEFAULT_AUDIO_CONFIG.max_db
VN_DB: float = DEFAULT_AUDIO_CONFIG.vn_db
MULAW_BINS: int = DEFAULT_AUDIO_CONFIG.mulaw_bins

# preprocess duration/text filters (seconds; ratio)
MIN_WAV_RATE: int = 2
MAX_WAV_RATE: int = 15
MIN_TXT_RATE: float = 0

# host-side worker pool size
NUM_WORKERS: int = max(1, multiprocessing.cpu_count() // 2)

# -- vocabularies ------------------------------------------------------------

IDX_TO_ENG: List[str] = _eng_symbols
ENG_TO_IDX: Dict[str, int] = _index_map(IDX_TO_ENG)
ENG_VOCA_SIZE: int = len(IDX_TO_ENG)

IDX_TO_KOR_PHN: List[str] = _kor_phonemes
KOR_PHN_TO_IDX: Dict[str, int] = _index_map(IDX_TO_KOR_PHN)
KOR_PHN_SIZE: int = len(IDX_TO_KOR_PHN)

IDX_TO_KOR_GRP: List[str] = _kor_graphemes
KOR_GRP_TO_IDX: Dict[str, int] = _index_map(IDX_TO_KOR_GRP)
KOR_GRP_SIZE: int = len(IDX_TO_KOR_GRP)
