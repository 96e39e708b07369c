"""MUSDB18-HQ source-separation meta (https://zenodo.org/record/3338373): the
port's copy of ``pytorch_sound_tpu/data/meta/musdb18.py``, the DSD100 meta
on mixture + vocals chunks only (no background column: the separation
recipe's background target is then mixture - vocals)."""

import glob
import os
from typing import List, Tuple

from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.meta import MetaTable, MetaType
from pytorch_sound_tpu_torch.data.meta.base import make_loaders
from pytorch_sound_tpu_torch.data.meta.commons import split_train_val_frame
from pytorch_sound_tpu_torch.data.meta.dsd100 import DSD100Meta


class MUSDB18Meta(DSD100Meta):

    @property
    def columns(self) -> List[Tuple[MetaType, str]]:
        return [(MetaType.AUDIO, 'mixture_filename'), (MetaType.AUDIO, 'voice_filename')]

    def make_meta(self, root_dir: str):
        """Scan <root>/*/*/{mixture,vocals}.<i>.npy chunk pairs."""
        print('Lookup files ...')
        mixture_list = glob.glob(os.path.join(root_dir, '*', '*', 'mixture.*.npy'))
        # only vocals are extracted; override for other stems
        vocals_list = glob.glob(os.path.join(root_dir, '*', '*', 'vocals.*.npy'))

        print('Make meta information ...')
        self._meta = MetaTable({'mixture_filename': sorted(mixture_list),
                                'voice_filename': sorted(vocals_list)})
        train_meta, val_meta = split_train_val_frame(self._meta, val_rate=0.1)
        self.finalize_and_save(train_meta, val_meta)


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, audio_mask: bool = False,
                 pad_multiple: int = 1) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        MUSDB18Meta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, audio_mask=audio_mask),
        train_loader_kwargs=dict(is_bucket=False),
        valid_loader_kwargs=dict(is_bucket=False),
        pad_multiple=pad_multiple)
