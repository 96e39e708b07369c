"""Maestro frame-level piano transcription on one card or, under
``torchrun``, data parallel over several (``main(use_mesh=True)``).

Counterpart of ``pytorch_sound_tpu/examples/maestro.py``: the audio (44.1
kHz) and the piano roll of each performance come from the meta
(:func:`~pytorch_sound_tpu_torch.data.meta.maestro.get_datasets`); per step
the log-mel is computed on the device by
:class:`~pytorch_sound_tpu_torch.models.transforms.LogMelSpectrogram`
(1024 / 1024 / 256, 80 mels from 0 Hz to sr / 2, log(mel + 1e-6) clipped to
-50 / 30 dB), which on a CUDA tensor is one launch of the log-mel kernel;
the roll is resampled onto the mel frames (:func:`align_roll`), and the
loss is the frame BCE of the ``frame_pitch`` net's logits against it.

Run: ``python -m pytorch_sound_tpu_torch.examples.maestro META_DIR SAVE_DIR
[--batch_size 4 --fix_len 131072 --max_step ... --device cuda]``.
"""

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch import settings
from pytorch_sound_tpu_torch.data.meta import maestro
from pytorch_sound_tpu_torch.models import build_model
import pytorch_sound_tpu_torch.models.transcription  # noqa: F401 (registration)
from pytorch_sound_tpu_torch.models.transforms import LogMelSpectrogram
from pytorch_sound_tpu_torch.parallel.mesh import recipe_data_parallel
from pytorch_sound_tpu_torch.trainer import LogType, Trainer, adamw

MAESTRO_SR = 44100
ROLL_FS = 100   # pretty_midi get_piano_roll default frames/sec

LOG_MEL = LogMelSpectrogram(MAESTRO_SR, settings.MEL_SIZE, settings.N_FFT,
                            settings.WIN_LENGTH, settings.HOP_LENGTH, settings.MIN_DB,
                            settings.MAX_DB, settings.MEL_MIN, None)


def roll_index(n_frames: int, t_roll: int) -> np.ndarray:
    """The piano-roll column of each mel frame: the frame's start time
    (frame * hop / sr) at the roll's 100 frames a second, truncated and
    clipped to the roll. In float32, in the JAX recipe's order of
    operations: at frames that are multiples of 441 the exact value is an
    integer, which float32 rounding leaves on either side."""
    frames = np.arange(n_frames, dtype=np.int32) * np.int32(settings.HOP_LENGTH)
    times = frames.astype(np.float32) / np.float32(MAESTRO_SR)
    idx = (times * np.float32(ROLL_FS)).astype(np.int32)
    return np.clip(idx, 0, t_roll - 1).astype(np.int64)


def align_roll(roll: torch.Tensor, n_frames: int) -> torch.Tensor:
    """A (N, 128, T_roll) piano roll resampled onto ``n_frames`` mel frames,
    nearest earlier column (:func:`roll_index`)."""
    idx = torch.from_numpy(roll_index(n_frames, roll.shape[-1])).to(roll.device)
    return roll[..., idx]


class MaestroTrainer(Trainer):
    """The forward contract on (audio, piano_roll) batches: the log-mel on
    the device, the frame BCE against the aligned roll."""

    def forward(self, audio: torch.Tensor, piano_roll: torch.Tensor, *rest,
                is_logging: bool = False) -> Tuple[torch.Tensor, Dict]:
        mel = LOG_MEL(audio)                                        # (N, 80, frames)
        logits = self.model(mel)
        target = (align_roll(piano_roll, logits.shape[-1]) > 0).float()

        loss = F.binary_cross_entropy_with_logits(logits, target)
        meta = {}
        if is_logging:
            pred = (logits > 0).float()
            tp = torch.sum(pred * target)
            precision = tp / torch.clamp(torch.sum(pred), min=1.0)
            recall = tp / torch.clamp(torch.sum(target), min=1.0)
            meta = {
                'loss': (loss, LogType.SCALAR),
                'precision': (precision, LogType.SCALAR),
                'recall': (recall, LogType.SCALAR),
                'mel': (mel[0], LogType.IMAGE),
            }
        return loss, meta


def main(meta_dir: str, save_dir: str, batch_size: int = 4, num_workers: int = 2,
         fix_len: int = 131072, max_step: int = 50000, valid_max_step: int = 20,
         save_interval: int = 2000, log_interval: int = 50, lr: float = 3e-4,
         arch: str = 'frame_pitch_base', use_mesh: bool = True, device: str = 'cuda'):
    """Train the frame-pitch net on a Maestro meta directory, as the JAX
    recipe's ``main`` does: crops of ``fix_len`` samples with their whole
    rolls, AdamW (optax's defaults, weight decay 1e-4) at ``lr``, gradients
    clipped to a global norm of 3, checkpoints under
    ``save_dir/models/maestro/``; returns the best validation loss.
    ``device``: 'cuda' (the default; raises without a card) or 'cpu'.
    ``use_mesh``: data parallel over the ranks of a ``torchrun`` job (one
    process a card: ``torchrun --nproc_per_node=N -m
    pytorch_sound_tpu_torch.examples.maestro ... --use_mesh True``), as
    the JAX recipe runs over its devices: ``batch_size`` stays the global
    batch and must divide over the ranks, each rank loads its shard of the
    metas, ``batch_size // world`` rows a step, on ``cuda:LOCAL_RANK``. In
    one process it is the one-card path. It is on by default, as in JAX,
    which runs data parallel wherever it sees more than one device."""
    mesh, shard, device, rows = recipe_data_parallel(use_mesh, device, batch_size)
    train_loader, valid_loader = maestro.get_datasets(
        meta_dir, batch_size=rows, num_workers=num_workers, fix_len=fix_len,
        pad_multiple=fix_len, shard=shard)
    model = build_model(arch)
    trainer = MaestroTrainer(
        model, adamw(model.parameters(), lr), train_loader, valid_loader,
        max_step=max_step, valid_max_step=valid_max_step, save_interval=save_interval,
        log_interval=log_interval, save_dir=save_dir, save_prefix='maestro', sr=MAESTRO_SR,
        grad_norm=3.0, device=device, mesh=mesh)
    return trainer.run()


if __name__ == '__main__':
    from pytorch_sound_tpu_torch.utils.cli import fire_like
    fire_like(main)
