"""Maestro piano dataset meta (https://magenta.tensorflow.org/datasets/maestro):
the port's copy of ``pytorch_sound_tpu/data/meta/maestro.py``. It wraps the
official maestro-v1.0.0 metadata (no preprocessing needed) into AUDIO + MIDI
columns, without pandas: the ``.csv``, the released ``.json`` (a list of
records) and a column-oriented ``.json`` (pandas' ``to_json``, which
:meth:`MaestroMeta.make_meta` of either package writes) are read as pandas
reads them; any other extension is refused."""

import os
from typing import List, Tuple

from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.meta import (
    MetaFrame, MetaTable, MetaType, read_table_csv, read_table_json, write_table_json)
from pytorch_sound_tpu_torch.data.meta.base import make_loaders
from pytorch_sound_tpu_torch.data.meta.commons import split_train_val_frame


class MaestroMeta(MetaFrame):

    frame_file_names: List[str] = ['maestro-v1.0.0.json', 'maestro-v1.0.0-train.json',
                                   'maestro-v1.0.0-valid.json']

    def __init__(self, meta_path: str, min_wav_rate: float = 0.0,
                 max_wav_rate: float = 0.0, sr: int = 44100):
        self.meta_path = meta_path
        self.root_dir = os.path.split(self.meta_path)[-2]
        self._meta = self._read_official_meta(meta_path)
        self.min_wav_rate = min_wav_rate
        self.max_wav_rate = max_wav_rate
        self.sr = sr

    @staticmethod
    def _read_official_meta(path: str) -> MetaTable:
        if not os.path.exists(path):
            raise RuntimeError(f'meta file not found: {path}')
        readers = {'.csv': read_table_csv, '.json': read_table_json}
        reader = readers.get(os.path.splitext(path)[1])
        if reader is None:
            raise RuntimeError(
                f'unsupported meta format {path!r}: point this at the '
                f'official maestro-v1.0.0 .csv or .json metadata file')
        return reader(path)

    @property
    def columns(self) -> List[Tuple[MetaType, str]]:
        return [(MetaType.AUDIO, 'audio_filename'), (MetaType.MIDI, 'midi_filename'),
                (MetaType.META, 'duration')]

    @property
    def meta(self) -> MetaTable:
        return self._meta

    def __len__(self):
        return len(self._meta)

    def save_meta(self, meta_dir: str, all_frame: MetaTable, train_frame: MetaTable,
                  val_frame: MetaTable):
        for name, frame in zip(self.frame_file_names, (all_frame, train_frame, val_frame)):
            write_table_json(frame, os.path.join(meta_dir, name))

    def make_meta(self):
        """Absolutise the official meta's relative paths and split train / val;
        the three frames are written beside the official file (the first
        over it, as in the JAX package)."""
        for col in ('audio_filename', 'midi_filename'):
            self._meta[col] = [os.path.join(self.root_dir, rel) for rel in self._meta[col]]

        print('splitting maestro meta into train / val frames')
        train_meta, val_meta = split_train_val_frame(self._meta)
        print(f"writing meta frames: {' '.join(self.frame_file_names)}")
        self.save_meta(self.root_dir, self._meta, train_meta, val_meta)


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, skip_audio: bool = False,
                 pad_multiple: int = 1,
                 shard: Tuple[int, int] = (0, 1)) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        MaestroMeta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, skip_audio=skip_audio),
        pad_multiple=pad_multiple, shard=shard)


if __name__ == '__main__':
    import sys
    meta_path = sys.argv[1]
    min_wav, max_wav = map(float, sys.argv[2:4])
    MaestroMeta(meta_path, min_wav, max_wav).make_meta()
