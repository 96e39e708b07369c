"""Shared base of the dataset metas and the loader construction helper: the
port's copy of ``pytorch_sound_tpu/data/meta/base.py``."""

import os
from typing import List, Optional, Tuple, Type

from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader, SpeechDataset
from pytorch_sound_tpu_torch.data.meta import MetaFrame, MetaTable, read_table_json
from pytorch_sound_tpu_torch.parallel.data import shard_meta_frame


class SpeechMetaFrame(MetaFrame):
    """MetaFrame with the standard [all/train/val]_meta.json file layout,
    duration-sorted loading, and speaker counting.

    A meta file is read as ``pd.read_json`` reads it and sorted by
    ``duration`` as pandas' ``sort_values`` sorts
    (:meth:`MetaTable.sort_values`: equal durations take numpy quicksort's
    order, which is pandas')."""

    frame_file_names: List[str] = ['all_meta.json', 'train_meta.json', 'val_meta.json']
    default_sr: int = 22050
    sort_key: Optional[str] = 'duration'

    def __init__(self, meta_path: str = '', sr: int = None):
        self.meta_path = meta_path
        if os.path.exists(self.meta_path) and not os.path.isdir(self.meta_path):
            self._meta = read_table_json(self.meta_path)
            if self.sort_key and self.sort_key in self._meta:
                self._meta = self._meta.sort_values(by=self.sort_key)
        else:
            self._meta = MetaTable({name: [] for name in self.column_names})
        self._num_speakers = None
        self.sr = sr if sr else self.default_sr

    @property
    def meta(self) -> MetaTable:
        return self._meta

    @property
    def num_speakers(self) -> int:
        if self._num_speakers is None:
            self._num_speakers = len(set(self._meta['speaker'].values))
        return self._num_speakers

    def __len__(self) -> int:
        return len(self._meta)

    @staticmethod
    def index_speakers(values) -> dict:
        """Stable speaker-name -> index mapping (sorted order)."""
        return {spk: idx for idx, spk in enumerate(sorted(set(values)))}

    def finalize_and_save(self, train_meta: MetaTable, val_meta: MetaTable):
        """Write [all, train, val] frames to ``meta_path``."""
        self.save_meta(self.frame_file_names, self.meta_path,
                       self._meta, train_meta, val_meta)


def make_loaders(meta_cls: Type[SpeechMetaFrame], meta_dir: str, batch_size: int,
                 num_workers: int, dataset_kwargs: dict = None,
                 train_loader_kwargs: dict = None,
                 valid_loader_kwargs: dict = None,
                 pad_multiple: int = 1, shard: Tuple[int, int] = (0, 1)
                 ) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    """Build (train_loader, valid_loader) from a meta directory — the shared
    body of every dataset's ``get_datasets``. ``shard`` (rank, world) keeps
    rank's strided shard of each meta's rows (``parallel.shard_meta_frame``),
    as a data-parallel rank loads them; a meta with fewer rows than ranks
    raises, since a rank would have none."""
    if not os.path.isdir(meta_dir):
        raise NotADirectoryError('{} is not valid directory path!'.format(meta_dir))
    train_file, valid_file = meta_cls.frame_file_names[1:]
    dataset_kwargs = dataset_kwargs or {}
    train_loader_kwargs = train_loader_kwargs or {}
    valid_loader_kwargs = valid_loader_kwargs or {}

    train_meta = meta_cls(os.path.join(meta_dir, train_file))
    valid_meta = meta_cls(os.path.join(meta_dir, valid_file))
    if shard[1] > 1:
        for name, meta in ((train_file, train_meta), (valid_file, valid_meta)):
            if len(meta) < shard[1]:
                raise ValueError('{} has {} rows for {} ranks'.format(
                    os.path.join(meta_dir, name), len(meta), shard[1]))
            shard_meta_frame(meta, *shard)
    train_dataset = SpeechDataset(train_meta, **dataset_kwargs)
    valid_dataset = SpeechDataset(valid_meta, **dataset_kwargs)

    train_loader = SpeechDataLoader(train_dataset, batch_size=batch_size,
                                    num_workers=num_workers,
                                    pad_multiple=pad_multiple, **train_loader_kwargs)
    valid_loader = SpeechDataLoader(valid_dataset, batch_size=batch_size,
                                    num_workers=num_workers,
                                    pad_multiple=pad_multiple, **valid_loader_kwargs)
    return train_loader, valid_loader
