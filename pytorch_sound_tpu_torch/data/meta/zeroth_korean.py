"""Zeroth-Korean ASR dataset meta (http://openslr.org/40): the port's copy of
``pytorch_sound_tpu/data/meta/zeroth_korean.py`` — text and KoG2P phoneme
columns, speaker ids from the utterance keys."""

import os
from typing import List, Tuple

from pytorch_sound_tpu_torch import settings
from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.korean.g2p import KoG2P
from pytorch_sound_tpu_torch.data.meta import MetaTable, MetaType, read_table_json
from pytorch_sound_tpu_torch.data.meta.base import SpeechMetaFrame, make_loaders
from pytorch_sound_tpu_torch.data.meta.commons import split_train_val_frame


class ZerothKoreanMeta(SpeechMetaFrame):

    @property
    def columns(self) -> List[Tuple[MetaType, str]]:
        return [(MetaType.AUDIO, 'audio_filename'), (MetaType.META, 'duration'),
                (MetaType.TEXT, 'text'), (MetaType.TEXT, 'phoneme'),
                (MetaType.SCALAR, 'speaker')]

    def make_meta(self, wav_file_list: List[str], text_file_list: List[str]):
        """Join wavs with transcript files ('<key> <text>' lines); derive
        speaker ids from the key prefix and phonemes via KoG2P. Speaker ids
        follow a set's order, as in the JAX package. A key without a wav or
        a transcript is dropped, as ``dropna`` drops it there."""
        info = {'audio_filename': {}, 'text': {}, 'phoneme': {}, 'speaker': {}}
        speakers = []

        for wav_path in wav_file_list:
            key = os.path.basename(wav_path)[:-len('.wav')]
            info['audio_filename'][key] = wav_path
            speakers.append(key.split('_')[0])

        speaker_map = {spk: idx for idx, spk in enumerate(set(speakers))}
        for key in info['audio_filename']:
            info['speaker'][key] = speaker_map[key.split('_')[0]]

        kog2p = KoG2P()
        for text_path in text_file_list:
            with open(text_path, 'r') as r:
                for line in r.readlines():
                    spl = line.split(' ')
                    key, text = spl[0], ' '.join(spl[1:])
                    info['text'][key] = text
                    info['phoneme'][key] = kog2p.g2p(text)

        self._meta = MetaTable(info)
        self._meta['pass'] = [True] * len(self._meta)

        print('Check durations on wave files ...')
        self._meta['duration'] = self._process_duration(
            self._meta['audio_filename'].values, settings.MIN_WAV_RATE, settings.MAX_WAV_RATE)

        columns = self._meta.columns
        self._meta = self._meta[[ok and all(self._meta[c][i] is not None for c in columns)
                                 for i, ok in enumerate(self._meta['pass'])]]
        train_meta, val_meta = split_train_val_frame(self._meta, val_rate=0.05)
        self.finalize_and_save(train_meta, val_meta)


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, skip_audio: bool = False, audio_mask: bool = False,
                 pad_multiple: int = 1) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        ZerothKoreanMeta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, skip_audio=skip_audio,
                            audio_mask=audio_mask),
        pad_multiple=pad_multiple)


def check_phn_dict(meta_path: str):
    """Print the set of phonemes appearing in a meta file's phoneme column."""
    table = read_table_json(meta_path)
    phoneme_set = {phn for phns in table['phoneme'] for phn in phns.split()}
    print('\n'.join(sorted(phoneme_set)))


if __name__ == '__main__':
    import sys
    check_phn_dict(sys.argv[1])
