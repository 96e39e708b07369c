"""LibriTTS dataset meta (http://www.openslr.org/60/, arxiv 1904.02882): the
port's copy of ``pytorch_sound_tpu/data/meta/libri_tts.py`` — speaker
directories <root>/<speaker>/{wav,txt}/, duration + text-ratio filtering,
bucketed train loader with skip_last_bucket, ``get_speakers``."""

import glob
import os
from itertools import repeat
from typing import Callable, List, Tuple

from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.meta import MetaTable, MetaType
from pytorch_sound_tpu_torch.data.meta.base import SpeechMetaFrame, make_loaders
from pytorch_sound_tpu_torch.data.meta.commons import split_train_val_frame


class LibriTTSMeta(SpeechMetaFrame):

    @property
    def columns(self) -> List[Tuple[MetaType, str]]:
        return [(MetaType.AUDIO, 'audio_filename'), (MetaType.SCALAR, 'speaker'),
                (MetaType.META, 'duration'), (MetaType.TEXT, 'text')]

    def make_meta(self, root_dir: str, min_wav_rate: int, max_wav_rate: int,
                  min_txt_rate: float):
        print('list up speakers')
        speakers = os.listdir(root_dir)

        print('lookup files...')
        wav_file_list = []
        speaker_mult = []
        for speaker in speakers:
            files = glob.glob(os.path.join(root_dir, speaker, 'wav', '*.wav'))
            wav_file_list.extend(files)
            speaker_mult.extend(repeat(speaker, len(files)))

        print('Update meta infos')
        speaker_map = self.index_speakers(speakers)
        # the declared columns first, then 'pass', as the JAX package's frame
        # (made empty with the declared columns) orders them
        n = len(wav_file_list)
        self._meta = MetaTable({name: [None] * n for name in self.column_names})
        self._meta['speaker'] = [speaker_map[s] for s in speaker_mult]
        self._meta['audio_filename'] = wav_file_list
        self._meta['pass'] = [True] * n

        print('Check durations on wave files ...')
        dur_list = self._process_duration(wav_file_list, min_wav_rate, max_wav_rate)
        self._meta['duration'] = dur_list

        print('Text pre-process ... ')
        txt_file_list = [p.replace('wav', 'txt') for p in wav_file_list]
        self._process_txt(txt_file_list, dur_list, min_txt_rate)

        self._meta = self._meta[self._meta['pass'].values]
        train_meta, val_meta = split_train_val_frame(self._meta)
        self.finalize_and_save(train_meta, val_meta)


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, skip_audio: bool = False, audio_mask: bool = False,
                 skip_last_bucket: bool = True, n_buckets: int = 10,
                 extra_features: List[Tuple[str, Callable]] = None,
                 pad_multiple: int = 1) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        LibriTTSMeta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, skip_audio=skip_audio,
                            audio_mask=audio_mask, extra_features=extra_features),
        train_loader_kwargs=dict(is_bucket=True, n_buckets=n_buckets,
                                 skip_last_bucket=skip_last_bucket),
        valid_loader_kwargs=dict(is_bucket=False),
        pad_multiple=pad_multiple)


def get_speakers(meta_dir: str) -> int:
    """Number of speakers in the train split."""
    if not os.path.isdir(meta_dir):
        raise NotADirectoryError('{} is not valid directory path!'.format(meta_dir))
    train_file = LibriTTSMeta.frame_file_names[1]
    return LibriTTSMeta(os.path.join(meta_dir, train_file)).num_speakers
