"""DSD100 source-separation meta (https://sigsep.github.io/datasets/dsd100.html):
the port's copy of ``pytorch_sound_tpu/data/meta/dsd100.py`` — mixture / voice
/ background .npy chunk triplets at 44.1 kHz, random 10 % split."""

import glob
from typing import List, Tuple

from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.meta import MetaTable, MetaType
from pytorch_sound_tpu_torch.data.meta.base import SpeechMetaFrame, make_loaders
from pytorch_sound_tpu_torch.data.meta.commons import split_train_val_frame


class DSD100Meta(SpeechMetaFrame):

    default_sr = 44100
    sort_key = None

    @property
    def columns(self) -> List[Tuple[MetaType, str]]:
        return [(MetaType.AUDIO, 'mixture_filename'), (MetaType.AUDIO, 'voice_filename'),
                (MetaType.AUDIO, 'background_filename')]

    def make_meta(self, mixtures: List[str], vocals: List[str], backgrounds: List[str]):
        """Expand each '<name>.npy' stem into its '<name>.<i>.npy' chunks."""
        def chunks(stems):
            return sorted(f for parent in stems
                          for f in glob.glob(parent.replace('.npy', '.*.npy')))

        self._meta = MetaTable({'mixture_filename': chunks(mixtures),
                                'voice_filename': chunks(vocals),
                                'background_filename': chunks(backgrounds)})
        train_meta, val_meta = split_train_val_frame(self._meta, val_rate=0.1)
        self.finalize_and_save(train_meta, val_meta)


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, audio_mask: bool = False,
                 pad_multiple: int = 1) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        DSD100Meta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, audio_mask=audio_mask),
        train_loader_kwargs=dict(is_bucket=False),
        valid_loader_kwargs=dict(is_bucket=False),
        pad_multiple=pad_multiple)
