"""Valenti noisy / clean dataset meta
(https://datashare.is.ed.ac.uk/handle/10283/2791): the port's copy of
``pytorch_sound_tpu/data/meta/valenti.py`` — the VoiceBank layout under its
own corpus root, with the same columns and pipeline."""

from typing import Tuple

from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.meta.base import make_loaders
from pytorch_sound_tpu_torch.data.meta.voice_bank import VoiceBankMeta


class ValentiMeta(VoiceBankMeta):
    """Same noisy / clean pairing pipeline as VoiceBank."""


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, skip_audio: bool = False, audio_mask: bool = False,
                 pad_multiple: int = 1) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        ValentiMeta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, skip_audio=skip_audio,
                            audio_mask=audio_mask),
        pad_multiple=pad_multiple)
