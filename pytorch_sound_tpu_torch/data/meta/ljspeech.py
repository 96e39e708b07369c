"""LJSpeech dataset meta (https://keithito.com/LJ-Speech-Dataset/): the port's
copy of ``pytorch_sound_tpu/data/meta/ljspeech.py`` — normalized text of
metadata.csv joined to the wavs by id, bucketed train loader."""

import os
from typing import Callable, Iterable, List, Optional, Tuple

from pytorch_sound_tpu_torch import settings
from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.meta import MetaTable, MetaType
from pytorch_sound_tpu_torch.data.meta.base import SpeechMetaFrame, make_loaders
from pytorch_sound_tpu_torch.data.meta.commons import split_train_val_frame


class LJSpeechMeta(SpeechMetaFrame):

    @property
    def columns(self) -> List[Tuple[MetaType, str]]:
        return [(MetaType.AUDIO, 'audio_filename'), (MetaType.META, 'duration'),
                (MetaType.TEXT, 'text')]

    def make_meta(self, wav_file_list: List[str],
                  txt_info: Iterable[Tuple[str, str, Optional[str]]]):
        """Join wav files with LJSpeech's metadata, given as rows of ``(id,
        text, normalized_text)`` (the lines of metadata.csv split on '|';
        the JAX package takes the same columns as a pandas frame). A row
        whose normalized text is missing (None) is dropped, as ``dropna``
        drops it there."""
        infos = {'audio_filename': {}, 'text': {}}
        wav_mapping = {os.path.basename(p).split('.')[0]: p for p in wav_file_list}

        for id_, _, norm_text in txt_info:
            if id_ in wav_mapping:
                infos['audio_filename'][id_] = wav_mapping[id_]
                infos['text'][id_] = norm_text

        self._meta = MetaTable(infos)
        self._meta['pass'] = [True] * len(self._meta)

        print('Check durations on wave files ...')
        dur_list = self._process_duration(self._meta['audio_filename'].values,
                                          settings.MIN_WAV_RATE, settings.MAX_WAV_RATE)
        self._meta['duration'] = dur_list

        self._meta = self._meta[[ok and text is not None for ok, text
                                 in zip(self._meta['pass'], self._meta['text'])]]
        train_meta, val_meta = split_train_val_frame(self._meta, val_rate=0.1)
        self.finalize_and_save(train_meta, val_meta)


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, skip_audio: bool = False, audio_mask: bool = False,
                 extra_features: List[Tuple[str, Callable]] = None,
                 pad_multiple: int = 1) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        LJSpeechMeta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, skip_audio=skip_audio,
                            audio_mask=audio_mask, extra_features=extra_features),
        train_loader_kwargs=dict(is_bucket=True, n_buckets=5),
        valid_loader_kwargs=dict(is_bucket=False),
        pad_multiple=pad_multiple)
