"""HiFi-GAN wav <-> mel interface with bundled checkpoints.

Counterpart of ``pytorch_sound_tpu/interface/hifi_gan.py``, with the same
``AudioParameters``, checkpoint paths, 2D-encode / 3D-decode contract and
streaming arithmetic. On a CUDA device, encode runs the fused log-mel kernel
and decode runs one fused generator-stage kernel per upsample stage, with
``conv_pre`` before the first (v2) or folded into it (v1)
(``generator_apply_fused`` on a decoder built with folded weights,
``use_weight_norm=False``, as the JAX interface builds it); on the CPU both
run their plain PyTorch versions. ``precision`` picks the stage kernels'
contraction ('highest', 'bf16x3', 'default') and ``dtype='bfloat16'`` runs
the layer-by-layer generator in bf16, as the JAX interface offers both.
"""

import os
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch.interface import Interface
from pytorch_sound_tpu_torch.models import build_model
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import (  # registers
    generator_apply_fused, load_jax_params)
from pytorch_sound_tpu_torch.ops.cuda.gen_stage import check_mode
from pytorch_sound_tpu_torch.ops.cuda.logmel import fused_hifigan_mel
from pytorch_sound_tpu_torch.utils.checkpoint import convert_state_dict, load_msgpack

Array = Union[np.ndarray, torch.Tensor]


class AudioParameters:

    sampling_rate: int = 22050
    n_fft: int = 1024
    window_size: int = 1024
    hop_size: int = 256
    num_mels: int = 80
    fmin: float = 0.
    fmax: float = 8000.


CHKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         '..', '..', 'assets', 'vocoders')
CHECKPOINTS = {
    'hifi_gan_v1': os.path.join(CHKPT_DIR, 'hifi_gan_v1.msgpack'),
    'hifi_gan_v2': os.path.join(CHKPT_DIR, 'hifi_gan_v2.msgpack'),
    'hifi_gan_v3': os.path.join(CHKPT_DIR, 'hifi_gan_v3.msgpack'),
}


class MelSpectrogram:
    """HiFi-GAN mel frontend: wav (..., T) -> log-mel (..., 80, frames).

    Runs the fused log-mel wrapper, which launches the kernel on a CUDA
    tensor and the plain version on a CPU tensor.
    """

    def __init__(self, sampling_rate: int = 22050, n_fft: int = 1024,
                 window_size: int = 1024, hop_size: int = 256, num_mels: int = 80,
                 fmin: float = 0., fmax: float = 8000.):
        self._kw = dict(sampling_rate=sampling_rate, n_fft=n_fft,
                        window_size=window_size, hop_size=hop_size,
                        num_mels=num_mels, fmin=fmin, fmax=fmax)

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        lead = wav.shape[:-1]
        mel = fused_hifigan_mel(wav.reshape(-1, wav.shape[-1]).contiguous(), **self._kw)
        return mel.reshape(*lead, *mel.shape[1:])

    forward = __call__


class InterfaceHifiGAN(Interface):
    """wav <-> mel <-> wav with a pretrained HiFi-GAN.

    model_name in ['hifi_gan_v1', 'hifi_gan_v2', 'hifi_gan_v3'] (only the v2
    checkpoint is bundled; pass ``chk_path`` for a flax .msgpack checkpoint
    or a torch ``.pt`` one, or ``params``, a JAX parameter tree of numpy
    arrays). ``device`` defaults to 'cuda' and raises when no card is
    present; pass ``device='cpu'`` for the plain PyTorch path. v1 and v2
    decode through one fused stage kernel per upsample stage; v1's conv_pre
    is folded into its first.

    ``precision`` is the stage kernels' contraction mode: 'highest' (fp32,
    the default), 'bf16x3' (three bf16 products of hi / lo splits, ~80 dB
    SNR against 'highest' on the bundled v2, where the JAX package reports
    ~35 dB on a TPU) or 'default' (one product of bf16-rounded operands,
    ~27 dB), the latter two on the bf16 tensor cores. ``dtype='bfloat16'``
    instead casts the decoder to bf16 and runs it layer by layer
    (``Generator.forward``; cuDNN's bf16 convs on the card, fp32
    accumulation), the output cast to fp32; ``precision`` is then unused, as
    in JAX, whose interface fuses only fp32 decoders. Other values of either
    raise ValueError.

    Example::

        interface = InterfaceHifiGAN('hifi_gan_v2')
        mel = interface.encode(wav)       # (N, T) -> (N, 80, T')
        pred_wav = interface.decode(mel)  # (N, 80, T') -> (N, 1, T'*256)
    """

    def __init__(self, model_name: str = 'hifi_gan_v1', chk_path: str = '',
                 device: Union[str, torch.device] = 'cuda', params=None,
                 dtype: str = 'float32', precision: str = 'highest'):
        valid = ['hifi_gan_v1', 'hifi_gan_v2', 'hifi_gan_v3']
        if model_name not in valid:
            raise AssertionError(
                'Model name {} is not valid! choose in {}'.format(model_name, valid))
        check_mode(precision)
        if dtype not in ('float32', 'bfloat16'):
            raise ValueError("dtype must be 'float32' or 'bfloat16', got %r" % (dtype,))
        self.precision = precision
        self.dtype = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "available; pass device='cpu' for the CPU path")

        self.encoder = MelSpectrogram(**{
            k: getattr(AudioParameters, k) for k in
            ('sampling_rate', 'n_fft', 'window_size', 'hop_size',
             'num_mels', 'fmin', 'fmax')})
        if params is None:
            params = self._load_params(chk_path or CHECKPOINTS[model_name])
        self.decoder = build_model(model_name, extra_kwargs={'use_weight_norm': False})
        self.decoder.load_state_dict(load_jax_params(params))
        self.decoder.to(self.device, self.dtype).eval().requires_grad_(False)

    @staticmethod
    def _load_params(path: str):
        """A flax ``.msgpack`` tree, or a torch HiFi-GAN ``.pt`` checkpoint
        (its ``'generator'`` entry when present) converted to one."""
        if not os.path.exists(path):
            raise AssertionError('{} does not exist; pass chk_path (a .msgpack or a '
                                 'torch .pt checkpoint) or params'.format(path))
        if path.endswith('.pt'):
            chkpt = torch.load(path, map_location='cpu', weights_only=True)
            return convert_state_dict(chkpt.get('generator', chkpt))
        return load_msgpack(path)

    def _tensor(self, x: Array) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @torch.inference_mode()
    def encode(self, wav_tensor: Array) -> torch.Tensor:
        if wav_tensor.ndim != 2:
            raise AssertionError('2D tensor (N, T) is needed')
        return self.encoder(self._tensor(wav_tensor))

    def _decode(self, mel: torch.Tensor) -> torch.Tensor:
        """The fused stages in ``precision``, or the bf16 generator."""
        if self.dtype == torch.bfloat16:
            return self.decoder(mel.to(torch.bfloat16)).float()
        return generator_apply_fused(self.decoder, mel, precision=self.precision)

    @torch.inference_mode()
    def decode(self, mel_tensor: Array) -> torch.Tensor:
        if mel_tensor.ndim != 3:
            raise AssertionError('3D tensor (N, C, T) is needed')
        return self._decode(self._tensor(mel_tensor))

    @torch.inference_mode()
    def decode_streaming(self, mel_tensor: Array, chunk_frames: int = 256,
                         overlap_frames: int = 32,
                         max_batch: int = 64) -> torch.Tensor:
        """Batched chunked decode for arbitrarily long mels.

        The mel is split into ``chunk_frames`` windows with ``overlap_frames``
        of context on each side (the v1 and v2 generators' receptive field is
        ~25 mel frames); all chunks are stacked into the batch axis and
        decoded in groups of ``max_batch``. Context samples are trimmed before
        reassembly. The sequence extremes are zero-padded; with sufficient
        overlap the interior matches :meth:`decode`, and only the outermost
        ~9 frames at each end differ (a chunk feeds zero mel frames through
        the network, while the full decode zero-pads every layer).
        """
        if mel_tensor.ndim != 3:
            raise AssertionError('3D tensor (N, C, T) is needed')
        mel = self._tensor(mel_tensor)
        n, c, t = mel.shape
        up = 256   # samples per mel frame (prod of upsample rates)
        if t <= chunk_frames:
            return self.decode(mel)

        ctx = overlap_frames
        k = -(-t // chunk_frames)                       # chunks per item
        width = chunk_frames + 2 * ctx
        padded = F.pad(mel, (ctx, ctx + k * chunk_frames - t))
        windows = padded.unfold(2, width, chunk_frames)  # (n, c, k, width)
        windows = windows.permute(0, 2, 1, 3).reshape(n * k, c, width)

        pieces = [self._decode(windows[i:i + max_batch].contiguous())
                  for i in range(0, n * k, max_batch)]
        wav = torch.cat(pieces, dim=0)                  # (n*k, 1, width*up)
        wav = wav[..., ctx * up: (ctx + chunk_frames) * up]
        wav = wav.reshape(n, k, 1, chunk_frames * up)
        wav = wav.permute(0, 2, 1, 3).reshape(n, 1, k * chunk_frames * up)
        return wav[..., : t * up]
