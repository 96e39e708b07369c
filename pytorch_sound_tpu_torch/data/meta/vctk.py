"""VCTK dataset meta (https://datashare.is.ed.ac.uk/handle/10283/2651): the
port's copy of ``pytorch_sound_tpu/data/meta/vctk.py`` — columns (audio,
speaker, duration, text), wav/txt key matching, duration+text filtering,
speaker-stratified split, bucketed train loader (n_buckets=5)."""

import glob
import os
from typing import Callable, List, Tuple

from pytorch_sound_tpu_torch import settings
from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.meta import MetaTable, MetaType
from pytorch_sound_tpu_torch.data.meta.base import SpeechMetaFrame, make_loaders
from pytorch_sound_tpu_torch.data.meta.commons import split_train_val_frame


class VCTKMeta(SpeechMetaFrame):

    @property
    def columns(self) -> List[Tuple[MetaType, str]]:
        return [(MetaType.AUDIO, 'audio_filename'), (MetaType.SCALAR, 'speaker'),
                (MetaType.META, 'duration'), (MetaType.TEXT, 'text')]

    def make_meta(self, root_dir: str, wav_file_list: List[str] = None,
                  txt_file_list: List[str] = None):
        """Scan <root>/<speaker>/{wav,txt}/* pairs into meta frames; rows are
        keyed by utterance id, in the order glob lists the wavs."""
        print('Lookup if not provided lists')
        if not wav_file_list:
            wav_file_list = glob.glob(os.path.join(root_dir, '*', 'wav', '*.wav'))
        if not txt_file_list:
            txt_file_list = glob.glob(os.path.join(root_dir, '*', 'txt', '*.txt'))

        wav_by_key = {os.path.basename(p)[:-len('.wav')]: p for p in wav_file_list}
        txt_by_key = {os.path.basename(p)[:-len('.txt')]: p for p in txt_file_list}

        infos = {'speaker': {}, 'audio_filename': {}, 'text': {}}
        print('Mapping information with their keys')
        for key, wav_path in wav_by_key.items():
            if key in txt_by_key:
                infos['speaker'][key] = wav_path.split(os.sep)[-3]
                infos['audio_filename'][key] = wav_path
                infos['text'][key] = txt_by_key[key]

        self._meta = MetaTable(infos)
        speaker_map = self.index_speakers(self._meta['speaker'].values)
        self._meta['speaker'] = [speaker_map[s] for s in self._meta['speaker'].values]
        self._meta['pass'] = [True] * len(self._meta)

        print('Check durations on wave files ...')
        dur_list = self._process_duration(self._meta['audio_filename'].values,
                                          settings.MIN_WAV_RATE, settings.MAX_WAV_RATE)
        self._meta['duration'] = dur_list

        print('Text pre-process ... ')
        self._process_txt(self._meta['text'].values, dur_list, 0.0)

        self._meta = self._meta[self._meta['pass'].values]
        train_meta, val_meta = split_train_val_frame(self._meta, val_rate=0.1)
        self.finalize_and_save(train_meta, val_meta)


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, skip_audio: bool = False, audio_mask: bool = False,
                 extra_features: List[Tuple[str, Callable]] = None,
                 pad_multiple: int = 1) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        VCTKMeta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, skip_audio=skip_audio,
                            audio_mask=audio_mask, extra_features=extra_features),
        train_loader_kwargs=dict(is_bucket=True, n_buckets=5),
        valid_loader_kwargs=dict(is_bucket=False),
        pad_multiple=pad_multiple)


if __name__ == '__main__':
    import sys
    root_dir, meta_path = sys.argv[1:3]
    VCTKMeta(meta_path).make_meta(root_dir)
