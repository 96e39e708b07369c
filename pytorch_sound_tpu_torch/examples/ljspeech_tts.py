"""LJSpeech text-to-mel training (Transformer-TTS, teacher-forced) on one card.

Counterpart of ``pytorch_sound_tpu/examples/ljspeech_tts.py``: text ids
(``eng_t2i`` with EOS) -> mel through ``TransformerTTS``; mel -> wav is the
bundled HiFi-GAN's ``InterfaceHifiGAN.decode`` or Griffin-Lim. Each step's
log-mel targets are computed on the device by
:class:`~pytorch_sound_tpu_torch.models.transforms.LogMelSpectrogram` at the
settings' geometry (22.05 kHz, 1024 / 1024 / 256, 80 mels, 0-8000 Hz, clip
-50 / 30 dB), which on a CUDA tensor is one launch of the log-mel kernel; the
losses are masked by the frame mask derived from the loader's wave mask.

Run: ``python -m pytorch_sound_tpu_torch.examples.ljspeech_tts META_DIR SAVE_DIR
[--batch_size 16 --max_step ... --device cuda]``.
"""

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch import settings
from pytorch_sound_tpu_torch.data.meta import ljspeech
from pytorch_sound_tpu_torch.models import build_model
from pytorch_sound_tpu_torch.models import tts  # noqa: F401 (registration)
from pytorch_sound_tpu_torch.models.transforms import LogMelSpectrogram
from pytorch_sound_tpu_torch.ops.mel import db_to_log
from pytorch_sound_tpu_torch.ops.sound import spectrogram_mask
from pytorch_sound_tpu_torch.trainer import LogType, Trainer, adamw

LOG_MEL = LogMelSpectrogram(settings.SAMPLE_RATE, settings.MEL_SIZE, settings.N_FFT,
                            settings.WIN_LENGTH, settings.HOP_LENGTH, settings.MIN_DB,
                            settings.MAX_DB, settings.MEL_MIN, settings.MEL_MAX)


class TTSTrainer(Trainer):
    """The forward contract on (wav, text[, wav_mask]) batches: the log-mel
    targets on the device, teacher forcing from a go frame, masked L1 +
    stop-token BCE."""

    def forward(self, wav: torch.Tensor, text: torch.Tensor, *rest,
                is_logging: bool = False) -> Tuple[torch.Tensor, Dict]:
        mel = LOG_MEL(wav)                                        # (N, M, Tm)
        n, m, tm = mel.shape

        # frame-level validity from the wave mask (all ones when absent)
        if rest:
            frame_mask = spectrogram_mask(rest[0], settings.WIN_LENGTH,
                                          settings.HOP_LENGTH)[:, :tm]
        else:
            frame_mask = mel.new_ones((n, tm))

        # teacher forcing: the decoder sees the mel shifted right by a go frame
        go = db_to_log(settings.MIN_DB)
        mel_in = torch.cat([mel.new_full((n, m, 1), go), mel[:, :, :-1]], dim=2)

        mel_out, stop_logits = self.model(text.long(), mel_in)

        denom = torch.clamp(frame_mask.sum(), min=1.0)
        mel_l1 = torch.sum(torch.abs(mel_out - mel) * frame_mask[:, None, :]) / (denom * m)
        # stop target: 1 on the first padded frame after the utterance
        ends = torch.cat([frame_mask[:, :-1] - frame_mask[:, 1:],
                          frame_mask.new_zeros((n, 1))], dim=1).clamp(0, 1)
        stop_bce = torch.mean(
            F.binary_cross_entropy_with_logits(stop_logits, ends, reduction='none')
            * torch.maximum(frame_mask, ends))
        loss = mel_l1 + stop_bce

        meta = {}
        if is_logging:
            meta = {
                'loss': (loss, LogType.SCALAR),
                'mel_l1': (mel_l1, LogType.SCALAR),
                'stop_bce': (stop_bce, LogType.SCALAR),
                'mel_pred': (mel_out[0], LogType.IMAGE),
                'mel_target': (mel[0], LogType.IMAGE),
            }
        return loss, meta


def main(meta_dir: str, save_dir: str, batch_size: int = 16, num_workers: int = 2,
         fix_len: int = 0, max_step: int = 300000, valid_max_step: int = 20,
         save_interval: int = 2000, log_interval: int = 50, lr: float = 1e-4,
         arch: str = 'transformer_tts_base', device: str = 'cuda'):
    """Train ``arch`` on an LJSpeech meta directory, as the JAX recipe's
    ``main`` does: utterances padded to a multiple of 16384 samples with
    their wave masks, AdamW (optax's defaults) at ``lr`` with b2 = 0.98,
    gradients clipped to a global norm of 1, checkpoints under
    ``save_dir/models/ljspeech_tts/``; returns the best validation loss.
    ``device``: 'cuda' (the default; raises without a card) or 'cpu'."""
    train_loader, valid_loader = ljspeech.get_datasets(
        meta_dir, batch_size=batch_size, num_workers=num_workers, fix_len=fix_len,
        audio_mask=True, pad_multiple=16384)
    model = build_model(arch)
    trainer = TTSTrainer(
        model, adamw(model.parameters(), lr, b1=0.9, b2=0.98), train_loader, valid_loader,
        max_step=max_step, valid_max_step=valid_max_step, save_interval=save_interval,
        log_interval=log_interval, save_dir=save_dir, save_prefix='ljspeech_tts',
        grad_norm=1.0, device=device)
    return trainer.run()


if __name__ == '__main__':
    from pytorch_sound_tpu_torch.utils.cli import fire_like
    fire_like(main)
