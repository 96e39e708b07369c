"""VoiceBank speech enhancement: the spectral-masking recipe on one card or,
under ``torchrun``, data parallel over several (``main(use_mesh=True)``).

Counterpart of ``pytorch_sound_tpu/examples/voice_bank.py``. Noisy / clean
pairs come from the dataset's meta files
(:func:`~pytorch_sound_tpu_torch.data.meta.voice_bank.get_datasets`); per step
the STFT magnitudes of both are computed on the device, a registry-built mask
net (``spec_masker_base`` by default) masks the noisy one, and the loss is
the magnitude L1 plus the log1p-magnitude L1. :func:`enhance` is the
inference path: the mask applied to the noisy STFT, the noisy phase kept, the
exact iSTFT back to a waveform.

Run: ``python -m pytorch_sound_tpu_torch.examples.voice_bank META_DIR SAVE_DIR
[--batch_size 8 --fix_len 32768 --max_step ... --device cuda]``.
"""

from typing import Dict, Tuple

import torch

from pytorch_sound_tpu_torch import settings
from pytorch_sound_tpu_torch.data.meta import voice_bank
from pytorch_sound_tpu_torch.models import build_model
import pytorch_sound_tpu_torch.models.enhancement  # noqa: F401 (registration)
from pytorch_sound_tpu_torch.ops import stft as stft_ops
from pytorch_sound_tpu_torch.parallel.mesh import recipe_data_parallel
from pytorch_sound_tpu_torch.trainer import LogType, Trainer, adam


def magnitude(wav: torch.Tensor) -> torch.Tensor:
    """|STFT| at the settings' geometry (n_fft / win 1024, hop 256, centered)."""
    return stft_ops.spectrogram_magnitude(wav, settings.N_FFT, settings.HOP_LENGTH,
                                          settings.WIN_LENGTH)


class VoiceBankTrainer(Trainer):
    """The forward contract on (noisy, clean, ...) batches: the magnitudes
    on the device, the mask net, mag-L1 + log1p-L1."""

    def forward(self, noisy: torch.Tensor, clean: torch.Tensor, *rest,
                is_logging: bool = False) -> Tuple[torch.Tensor, Dict]:
        noisy_mag = magnitude(noisy)
        clean_mag = magnitude(clean)
        est_mag = self.model(noisy_mag) * noisy_mag
        mag_l1 = torch.mean(torch.abs(est_mag - clean_mag))
        log_l1 = torch.mean(torch.abs(torch.log1p(est_mag) - torch.log1p(clean_mag)))
        loss = mag_l1 + log_l1
        meta = {}
        if is_logging:
            meta = {
                'loss': (loss, LogType.SCALAR),
                'mag_l1': (mag_l1, LogType.SCALAR),
                'log_l1': (log_l1, LogType.SCALAR),
                'est_mag': (torch.log1p(est_mag[0]), LogType.IMAGE),
            }
        return loss, meta


@torch.no_grad()
def enhance(model, noisy: torch.Tensor) -> torch.Tensor:
    """Denoise waveforms (N, T) -> (N, T) on ``noisy``'s device: the model's
    magnitude mask on the noisy STFT, the noisy phase, the exact iSTFT."""
    real, imag = stft_ops.stft(noisy, settings.N_FFT, settings.HOP_LENGTH,
                               settings.WIN_LENGTH)
    mask = model(torch.sqrt(real * real + imag * imag))
    return stft_ops.istft(mask * real, mask * imag, settings.N_FFT, settings.HOP_LENGTH,
                          settings.WIN_LENGTH, length=noisy.shape[-1])


def main(meta_dir: str, save_dir: str, batch_size: int = 8, num_workers: int = 2,
         fix_len: int = 32768, max_step: int = 10000, valid_max_step: int = 20,
         save_interval: int = 1000, log_interval: int = 50, lr: float = 2e-4,
         arch: str = 'spec_masker_base', use_mesh: bool = False, device: str = 'cuda'):
    """Train the mask net on a VoiceBank meta directory, as the JAX recipe's
    ``main`` does: crops of ``fix_len`` samples, Adam (optax's formula) at
    ``lr``, gradients clipped to a global norm of 5, checkpoints under
    ``save_dir/models/voice_bank/``; returns the best validation loss.
    ``device``: 'cuda' (the default; raises without a card) or 'cpu'.
    ``use_mesh``: data parallel over the ranks of a ``torchrun`` job (one
    process a card: ``torchrun --nproc_per_node=N -m
    pytorch_sound_tpu_torch.examples.voice_bank ... --use_mesh True``), as
    the JAX recipe runs over its devices: ``batch_size`` stays the global
    batch and must divide over the ranks, each rank loads its shard of the
    metas, ``batch_size // world`` rows a step, on ``cuda:LOCAL_RANK``. In
    one process it is the one-card path."""
    mesh, shard, device, rows = recipe_data_parallel(use_mesh, device, batch_size)
    train_loader, valid_loader = voice_bank.get_datasets(
        meta_dir, batch_size=rows, num_workers=num_workers, fix_len=fix_len,
        pad_multiple=fix_len, shard=shard)
    model = build_model(arch)
    trainer = VoiceBankTrainer(
        model, adam(model.parameters(), lr), train_loader, valid_loader,
        max_step=max_step, valid_max_step=valid_max_step, save_interval=save_interval,
        log_interval=log_interval, save_dir=save_dir, save_prefix='voice_bank',
        grad_norm=5.0, device=device, mesh=mesh)
    return trainer.run()


if __name__ == '__main__':
    from pytorch_sound_tpu_torch.utils.cli import fire_like
    fire_like(main)
