"""pytorch_sound_tpu_torch — the PyTorch/CUDA port of pytorch_sound_tpu.

The JAX package ``pytorch_sound_tpu`` stays the numerical reference; this
package mirrors its module paths so each counterpart is found by name. It
imports ``torch`` and never ``jax``, ``flax`` or the JAX package, so it runs
where only PyTorch is installed.

What runs today is the HiFi-GAN serving path (``interface.hifi_gan``): the
log-mel encode and the v2 generator decode, with hand-written CUDA kernels for
the fused generator stage and the log-mel frontend (``ops/cuda``, ``csrc/``);
and HiFi-GAN adversarial training (``examples.hifi_gan.HiFiGANTrainer`` on
``trainer.Trainer``, the MPD / MSD critics, the trainable log-mel K4); the
attention building blocks (``models.modules``, ``ops.attention``), whose
blockwise route runs the flash-attention kernels; and the DSP layer
(``ops.stft``, ``ops.sound``, ``ops.pqmf``, ``models.transforms``,
``models.sound``) with the VoiceBank enhancement recipe
(``examples.voice_bank``, ``models.enhancement``); and feature extraction
(``scripts.preprocess``: the native audio runtime ``native`` built with g++
from ``csrc/tpusound.cc``, the resampler ``ops.resample``, the pinned-memory
prefetch ``parallel``, and the log-mel kernel).
"""

__version__ = '0.1.0'


def __getattr__(name):
    """Lazy convenience exports: ``build_model`` / ``Interface`` without
    importing torch at package import."""
    if name in ('build_model', 'register_model', 'register_model_architecture'):
        from pytorch_sound_tpu_torch import models
        return getattr(models, name)
    if name == 'Interface':
        from pytorch_sound_tpu_torch.interface import Interface
        return Interface
    raise AttributeError('module {!r} has no attribute {!r}'.format(__name__, name))
