"""Data movement between the host and the card: the port's counterpart of
``pytorch_sound_tpu/parallel/``. Only the prefetch is ported; the mesh,
per-host data feeding and ring attention wait for the multi-GPU port."""

from pytorch_sound_tpu_torch.parallel.prefetch import PinnedCopier, prefetch_to_device

__all__ = ['PinnedCopier', 'prefetch_to_device']
