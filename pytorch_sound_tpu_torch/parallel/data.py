"""Per-rank data feeding: the port's counterpart of
``pytorch_sound_tpu/parallel/data.py``.

JAX assembles one global batch from every host's local rows
(``global_batches``); under data parallelism in PyTorch each rank keeps
only its rows and the gradient mean is taken over ranks. So a rank loads
its own shard of the meta rows (:func:`shard_meta_frame`, the strided split
of :func:`process_shard_indices`) or takes its slice of a global batch
(:func:`local_batch`: rows ``[r B / W, (r + 1) B / W)``, the layout of
GSPMD's ``P('data')``). A batch whose leading size does not divide the
world is kept whole on every rank, as JAX's prefetch replicates it
(``pytorch_sound_tpu/parallel/prefetch.py:17-32``); the trainer's mean,
weighted by rows, then gives the same gradient.
"""

from typing import Iterable, Iterator, Optional

import numpy as np
import torch.distributed as dist


def _rank_world(process_index: Optional[int], process_count: Optional[int], group=None):
    initialized = dist.is_available() and dist.is_initialized()
    rank = process_index if process_index is not None else (
        dist.get_rank(group) if initialized else 0)
    world = process_count if process_count is not None else (
        dist.get_world_size(group) if initialized else 1)
    return rank, world


def process_shard_indices(n_items: int, process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> np.ndarray:
    """Indices of the meta rows this rank is responsible for: the strided
    split (``arange(rank, n, world)``), which keeps duration-sorted buckets
    balanced across ranks. Rank and world default to the default group's."""
    rank, world = _rank_world(process_index, process_count)
    return np.arange(rank, n_items, world)


def shard_meta_frame(meta_frame, process_index: Optional[int] = None,
                     process_count: Optional[int] = None):
    """Restrict a MetaFrame's rows to this rank's shard (in place); returns
    the frame."""
    idx = process_shard_indices(len(meta_frame), process_index, process_count)
    meta_frame._meta = meta_frame.meta.iloc[idx]
    return meta_frame


def _data_rank_world(mesh, axis: str):
    if mesh is None:
        return 0, 1
    return _rank_world(None, None, mesh.get_group(axis))


def local_batch(batch, mesh, axis: str = 'data'):
    """This rank's rows of a global batch (an array or a tuple / list of
    arrays, each sliced on its leading axis): ``[r B / W, (r + 1) B / W)``
    for rank ``r`` of ``W`` on ``axis``. An array whose leading size does not
    divide ``W`` (or a scalar) is kept whole, a straggler batch."""
    rank, world = _data_rank_world(mesh, axis)

    def one(x):
        shape = getattr(x, 'shape', ())
        if world == 1 or not len(shape) or shape[0] % world:
            return x
        n = shape[0] // world
        return x[rank * n:(rank + 1) * n]

    if isinstance(batch, (tuple, list)):
        return type(batch)(one(x) for x in batch)
    return one(batch)


class local_batches:
    """:func:`local_batch` of every batch of ``global_batches``: the
    counterpart of JAX's ``global_batches``, seen from one rank. Iterable
    as often as its source, as the trainer repeats its datasets."""

    def __init__(self, global_batches: Iterable, mesh, axis: str = 'data'):
        self.source, self.mesh, self.axis = global_batches, mesh, axis

    def __iter__(self) -> Iterator:
        for batch in self.source:
            yield local_batch(batch, self.mesh, self.axis)
