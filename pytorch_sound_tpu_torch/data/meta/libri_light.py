"""Libri-Light dataset meta (https://github.com/facebookresearch/libri-light):
the port's copy of ``pytorch_sound_tpu/data/meta/libri_light.py`` — VAD-chunked
wavs and speaker labels, with a speaker-map JSON beside the metas."""

import json
import os
from typing import List, Tuple

from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.meta import MetaTable, MetaType
from pytorch_sound_tpu_torch.data.meta.base import SpeechMetaFrame, make_loaders
from pytorch_sound_tpu_torch.data.meta.commons import split_train_val_frame


class LibriLightMeta(SpeechMetaFrame):

    @property
    def columns(self) -> List[Tuple[MetaType, str]]:
        return [(MetaType.AUDIO, 'audio_filename'), (MetaType.SCALAR, 'speaker'),
                (MetaType.META, 'duration')]

    def make_meta(self, chunk_file_list: List[str], speakers: List[str],
                  val_rate: float = 0.1):
        self._meta = MetaTable({'audio_filename': chunk_file_list, 'speaker': speakers})

        speaker_map = self.index_speakers(self._meta['speaker'].values)
        self._meta['speaker'] = [speaker_map[s] for s in self._meta['speaker'].values]
        self._meta['pass'] = [True] * len(self._meta)

        print('Check durations on wave files ...')
        self._meta['duration'] = self._process_duration(
            self._meta['audio_filename'].values, 0, 0)

        train_meta, val_meta = split_train_val_frame(self._meta, val_rate=val_rate)
        self.finalize_and_save(train_meta, val_meta)

        with open(os.path.join(self.meta_path, 'speaker_map.json'), 'w') as w:
            json.dump(speaker_map, w)


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, skip_audio: bool = False, audio_mask: bool = False,
                 pad_multiple: int = 1) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        LibriLightMeta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, skip_audio=skip_audio,
                            audio_mask=audio_mask),
        pad_multiple=pad_multiple)
