"""VoiceBank(-DEMAND) noisy/clean speech-enhancement meta: the port's copy of
``pytorch_sound_tpu/data/meta/voice_bank.py`` — paired noisy/clean AUDIO
columns, phase split by 'trainset' in the path."""

import glob
import os
from collections import defaultdict
from typing import List, Tuple

from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.meta import MetaTable, MetaType
from pytorch_sound_tpu_torch.data.meta.base import SpeechMetaFrame, make_loaders


class VoiceBankMeta(SpeechMetaFrame):

    @property
    def columns(self) -> List[Tuple[MetaType, str]]:
        return [(MetaType.AUDIO, 'noise_filename'), (MetaType.AUDIO, 'clean_filename'),
                (MetaType.SCALAR, 'speaker'), (MetaType.META, 'duration'),
                (MetaType.TEXT, 'text')]

    def make_meta(self, root_dir: str, min_wav_rate: int, max_wav_rate: int,
                  min_txt_rate: float):
        """Pair *_clean/*_noisy wavs by utterance key; split by trainset path."""
        info = defaultdict(dict)

        print('Lookup all files...')
        wav_file_list = glob.glob(os.path.join(root_dir, '**', '*.wav'))
        txt_file_list = glob.glob(os.path.join(root_dir, '**', '*.txt'))

        print('Match info structure')
        for wav_file in wav_file_list:
            key = os.path.basename(wav_file)[:-len('.wav')]
            info['clean_filename' if 'clean' in wav_file else 'noise_filename'][key] = wav_file
            info['phase'][key] = 'train' if 'trainset' in wav_file else 'valid'
            info['speaker'][key] = key[:4]
            info['script_id'][key] = key[-3:]
        for txt_file in txt_file_list:
            info['text'][os.path.basename(txt_file)[:-len('.txt')]] = txt_file
        print('Matching is completed ...')

        self._meta = MetaTable(info)
        speaker_map = self.index_speakers(self._meta['speaker'].values)
        self._meta['speaker'] = [speaker_map[s] for s in self._meta['speaker'].values]
        self._meta['pass'] = [True] * len(self._meta)

        print('Check durations on wave files ...')
        dur_list = self._process_duration(self._meta['noise_filename'].values,
                                          min_wav_rate, max_wav_rate)
        self._meta['duration'] = dur_list

        print('Text pre-process ... ')
        self._process_txt(self._meta['text'].values, dur_list, min_txt_rate)

        self._meta = self._meta[self._meta['pass'].values]
        is_train = self._meta['phase'].values == 'train'
        self.finalize_and_save(self._meta[is_train], self._meta[~is_train])


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, skip_audio: bool = False, audio_mask: bool = False,
                 pad_multiple: int = 1,
                 shard: Tuple[int, int] = (0, 1)) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        VoiceBankMeta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, skip_audio=skip_audio,
                            audio_mask=audio_mask),
        pad_multiple=pad_multiple, shard=shard)
