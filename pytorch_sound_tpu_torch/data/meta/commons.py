"""Train/validation splitting: the port's copy of
``pytorch_sound_tpu/data/meta/commons.py`` — speaker-stratified when a label
column exists, random otherwise."""

import random
from collections import defaultdict
from typing import Optional, Tuple

from pytorch_sound_tpu_torch.data.meta import MetaTable


def split_train_val_frame(data_frame: MetaTable, val_rate: float = 0.1,
                          label_key: str = 'speaker',
                          rng: Optional[random.Random] = None
                          ) -> Tuple[MetaTable, MetaTable]:
    """Split a meta frame; stratified per ``label_key`` value when present.
    The shuffles draw from ``rng``, by default the global ``random`` stream
    the JAX package draws from, so ``random.seed(s)`` gives both packages
    the same split. Each label keeps ``int(n * val_rate)`` of its rows for
    validation, which is none for a label with fewer than 1 / val_rate."""
    shuffle = (rng or random).shuffle
    total_len = len(data_frame)
    idx_list = list(range(total_len))

    if label_key in data_frame:
        by_label = defaultdict(list)
        for idx, label in enumerate(data_frame[label_key].values):
            by_label[label].append(idx)
        for key in by_label:
            shuffle(by_label[key])
        train_idx, val_idx = [], []
        for key in by_label:
            split_idx = int(len(by_label[key]) * val_rate)
            train_idx.extend(by_label[key][split_idx:])
            val_idx.extend(by_label[key][:split_idx])
    else:
        shuffle(idx_list)
        split_idx = int(total_len * val_rate)
        train_idx = idx_list[split_idx:]
        val_idx = idx_list[:split_idx]

    return data_frame.iloc[train_idx], data_frame.iloc[val_idx]
