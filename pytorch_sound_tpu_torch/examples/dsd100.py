"""DSD100 / MUSDB18 vocal separation: the U-Net masking recipe on one card or,
under ``torchrun``, data parallel over several (``main(use_mesh=True)``).

Counterpart of ``pytorch_sound_tpu/examples/dsd100.py``. Per step the STFT
magnitudes of the mixture and its sources are computed on the device
(``ops/stft.py``, cuFFT), the registry-built U-Net (``spec_unet_base`` by
default; cuDNN convs) masks the mixture's, and the loss is the L1 of the
vocal estimate against the vocal magnitude plus the L1 of the background
estimate ((1 - mask) * mixture) against the background magnitude, or
against mixture - vocal magnitude where the meta has no background column
(MUSDB18). :func:`separate` is the inference path: the mask on the
mixture's STFT, both sources rebuilt with the mixture's phase through the
exact iSTFT.

Run: ``python -m pytorch_sound_tpu_torch.examples.dsd100 META_DIR SAVE_DIR
[--batch_size 4 --fix_len 65536 --max_step ... --device cuda]``.
"""

from typing import Dict, Tuple

import torch

from pytorch_sound_tpu_torch import settings
from pytorch_sound_tpu_torch.data.meta import dsd100
from pytorch_sound_tpu_torch.models import build_model
import pytorch_sound_tpu_torch.models.separation  # noqa: F401 (registration)
from pytorch_sound_tpu_torch.ops import stft as stft_ops
from pytorch_sound_tpu_torch.parallel.mesh import recipe_data_parallel
from pytorch_sound_tpu_torch.trainer import LogType, Trainer, adam

SR = 44100


def magnitude(wav: torch.Tensor) -> torch.Tensor:
    """|STFT| at the settings' geometry (n_fft / win 1024, hop 256, centered)."""
    return stft_ops.spectrogram_magnitude(wav, settings.N_FFT, settings.HOP_LENGTH,
                                          settings.WIN_LENGTH)


class DSD100Trainer(Trainer):
    """Vocal-mask separation: the forward contract on (mixture, voice[,
    background]) batches."""

    def forward(self, mixture: torch.Tensor, voice: torch.Tensor, *rest,
                is_logging: bool = False) -> Tuple[torch.Tensor, Dict]:
        mix_mag = magnitude(mixture)
        voice_mag = magnitude(voice)

        mask = self.model(mix_mag)
        est_voice = mask * mix_mag
        est_background = (1.0 - mask) * mix_mag

        voice_l1 = torch.mean(torch.abs(est_voice - voice_mag))
        if rest:   # background column present (DSD100; MUSDB18 has none)
            bg_l1 = torch.mean(torch.abs(est_background - magnitude(rest[0])))
        else:
            bg_l1 = torch.mean(torch.abs(est_background - (mix_mag - voice_mag)))
        loss = voice_l1 + bg_l1

        meta = {}
        if is_logging:
            meta = {
                'loss': (loss, LogType.SCALAR),
                'voice_l1': (voice_l1, LogType.SCALAR),
                'background_l1': (bg_l1, LogType.SCALAR),
                'est_voice': (torch.log1p(est_voice[0]), LogType.IMAGE),
            }
        return loss, meta


@torch.no_grad()
def separate(model, mixture: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixtures (N, T) -> (voice, background) waveforms (N, T) on
    ``mixture``'s device: the model's mask on the mixture's STFT magnitude,
    the mixture's phase, the exact iSTFT of mask and 1 - mask."""
    real, imag = stft_ops.stft(mixture, settings.N_FFT, settings.HOP_LENGTH,
                               settings.WIN_LENGTH)
    mask = model(torch.sqrt(real * real + imag * imag))

    def recon(m):
        return stft_ops.istft(m * real, m * imag, settings.N_FFT, settings.HOP_LENGTH,
                              settings.WIN_LENGTH, length=mixture.shape[-1])

    return recon(mask), recon(1.0 - mask)


def main(meta_dir: str, save_dir: str, batch_size: int = 4, num_workers: int = 2,
         fix_len: int = 65536, max_step: int = 20000, valid_max_step: int = 20,
         save_interval: int = 1000, log_interval: int = 50, lr: float = 1e-4,
         arch: str = 'spec_unet_base', use_mesh: bool = False, device: str = 'cuda'):
    """Train the U-Net on a DSD100 meta directory, as the JAX recipe's
    ``main`` does: crops of ``fix_len`` samples at 44.1 kHz, Adam (optax's
    formula) at ``lr``, gradients clipped to a global norm of 5, checkpoints
    under ``save_dir/models/dsd100/``; returns the best validation loss.
    ``device``: 'cuda' (the default; raises without a card) or 'cpu'.
    ``use_mesh``: data parallel over the ranks of a ``torchrun`` job (one
    process a card: ``torchrun --nproc_per_node=N -m
    pytorch_sound_tpu_torch.examples.dsd100 ... --use_mesh True``), as
    the JAX recipe runs over its devices: ``batch_size`` stays the global
    batch and must divide over the ranks, each rank loads its shard of the
    metas, ``batch_size // world`` rows a step, on ``cuda:LOCAL_RANK``. In
    one process it is the one-card path."""
    mesh, shard, device, rows = recipe_data_parallel(use_mesh, device, batch_size)
    train_loader, valid_loader = dsd100.get_datasets(
        meta_dir, batch_size=rows, num_workers=num_workers, fix_len=fix_len,
        pad_multiple=fix_len, shard=shard)
    model = build_model(arch)
    trainer = DSD100Trainer(
        model, adam(model.parameters(), lr), train_loader, valid_loader,
        max_step=max_step, valid_max_step=valid_max_step, save_interval=save_interval,
        log_interval=log_interval, save_dir=save_dir, save_prefix='dsd100', sr=SR,
        grad_norm=5.0, device=device, mesh=mesh)
    return trainer.run()


if __name__ == '__main__':
    from pytorch_sound_tpu_torch.utils.cli import fire_like
    fire_like(main)
