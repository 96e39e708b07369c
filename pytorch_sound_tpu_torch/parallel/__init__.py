"""Data movement and parallelism across cards: the port's counterpart of
``pytorch_sound_tpu/parallel/``. One process per card (``torchrun``); the
default process group and a ``DeviceMesh`` over its ranks (``mesh``),
per-rank data (``data``), the pinned-memory prefetch (``prefetch``) and
ring attention over sequence shards (``ring_attention``). JAX's
``batch_sharding`` / ``replicated_sharding`` have no counterpart: a rank
holds its rows of a batch (``data.local_batch``) and a full copy of the
parameters, which the trainer broadcasts from rank 0 once."""

from pytorch_sound_tpu_torch.parallel.data import (local_batch, local_batches,
                                                   process_shard_indices, shard_meta_frame)
from pytorch_sound_tpu_torch.parallel.mesh import init_distributed, make_mesh, spawn_ranks
from pytorch_sound_tpu_torch.parallel.prefetch import PinnedCopier, prefetch_to_device

__all__ = ['init_distributed', 'make_mesh', 'spawn_ranks', 'process_shard_indices',
           'shard_meta_frame', 'local_batch', 'local_batches', 'PinnedCopier',
           'prefetch_to_device', 'data']
