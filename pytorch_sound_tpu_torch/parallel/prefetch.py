"""Host -> device batch prefetch: the port's counterpart of
``pytorch_sound_tpu/parallel/prefetch.py``.

``prefetch_to_device`` keeps ``size`` batches in flight, so that the copy of
batch N+1 overlaps the work on batch N. On a CUDA device each array goes
through :class:`PinnedCopier`: copied on the host into a page-locked
(pinned) staging buffer, then to the card with ``non_blocking=True`` on a
side stream, the only copy the card can overlap with compute (from a
pageable source CUDA stages the copy synchronously). The consumer's stream waits
for that batch's copy (``wait_event`` on the event recorded after it: the
``wait_stream`` of that point, without waiting for later batches' copies),
each tensor is marked used there (``record_stream``, so the allocator does
not hand its memory to the side stream while the consumer still reads it),
and a staging buffer is written again only after its copy's event has
completed. On the CPU the batch is only turned into tensors.

JAX's version places a global batch on a mesh, sharded on its leading axis
(``sharding=``). Here each rank runs its own prefetch onto its own device,
of its own rows: its shard of the metas, or
:class:`~pytorch_sound_tpu_torch.parallel.data.local_batches` of global
batches, which keeps a straggler batch whole, as JAX replicates it.
"""

import collections
import threading
from typing import Any, Iterable, Iterator, List, NamedTuple, Tuple, Union

import numpy as np
import torch


def _as_tensors(batch) -> Tuple[List[torch.Tensor], Any]:
    """(tensors, rebuild): a batch (array, or tuple / list of arrays) as
    CPU-or-device tensors, and the function that puts new tensors back in
    the batch's shape."""
    if isinstance(batch, (tuple, list)):
        return [torch.as_tensor(x) for x in batch], type(batch)
    return [torch.as_tensor(batch)], lambda ts: ts[0]


class PinnedPool:
    """Page-locked host buffers, reused by size. A buffer comes back with
    the event recorded after the copy that reads or writes it (None when the
    caller has waited for it), and is handed out again only after that event
    has completed. Threads may take and give back (one uploads, another
    saves)."""

    def __init__(self, keep: int = 16):
        self._free: List[Tuple[torch.Tensor, Any]] = []
        self._keep = keep
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            fits = [i for i, (buf, _) in enumerate(self._free) if buf.numel() >= nbytes]
            found = (self._free.pop(min(fits, key=lambda i: self._free[i][0].numel()))
                     if fits else None)
        if found is None:
            # a power of two from 64 KiB: batches of varying length reuse it
            return torch.empty(max(1 << 16, 1 << (max(nbytes, 1) - 1).bit_length()),
                               dtype=torch.uint8, pin_memory=True)
        buf, event = found
        if event is not None:
            event.synchronize()
        return buf

    def give(self, buf: torch.Tensor, event=None):
        with self._lock:
            self._free.append((buf, event))
            if len(self._free) > self._keep:    # drop the smallest; torch's host
                self._free.sort(key=lambda e: e[0].numel())   # allocator keeps it
                self._free.pop(0)               # until its copy is done


def pinned_view(pool: PinnedPool, shape, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(buffer, view): a pinned buffer from ``pool`` and a (shape, dtype)
    view of its front."""
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    itemsize = torch.empty((), dtype=dtype).element_size()
    buf = pool.take(n * itemsize)
    return buf, buf[:n * itemsize].view(dtype).view(shape)


class Pending(NamedTuple):
    """A batch whose copies are under way, between the events around them
    on the copier's stream (``start.elapsed_time(end)``: the copy's ms)."""
    batch: Any
    start: Any
    end: Any


class PinnedCopier:
    """Host arrays to one CUDA device through pinned staging on a side
    stream. :meth:`put` starts the copies and returns at once; :meth:`take`
    makes the current stream wait for them and returns the tensors."""

    def __init__(self, device: Union[str, torch.device]):
        self.device = torch.device(device)
        if self.device.type != 'cuda':
            raise ValueError('PinnedCopier copies to a CUDA device, not %s' % self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = PinnedPool()

    def put(self, batch) -> Pending:
        """Stage a batch in pinned memory and start its copies."""
        tensors, rebuild = _as_tensors(batch)
        staged, staging = [], []
        for t in tensors:
            if t.device == self.device:
                staged.append(t)
                continue
            buf, view = pinned_view(self.pool, t.shape, t.dtype)
            view.copy_(t)                           # host memcpy into pinned memory
            staged.append(view)
            staging.append(buf)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record(self.stream)
            out = [t.to(self.device, non_blocking=True) for t in staged]
            end.record(self.stream)
        for buf in staging:
            self.pool.give(buf, end)
        return Pending(rebuild(out), start, end)

    def take(self, pending: Pending):
        """The batch of :meth:`put`, usable on the current stream."""
        current = torch.cuda.current_stream(self.device)
        current.wait_event(pending.end)
        batch = pending.batch
        for t in (batch if isinstance(batch, (tuple, list)) else [batch]):
            t.record_stream(current)
        return batch


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: Union[str, torch.device] = 'cuda') -> Iterator:
    """Yield batches (arrays, or tuples / lists of them) as tensors on
    ``device``, drawing ``size`` batches ahead of the consumer: at each
    yield, the next ``size`` batches have been drawn and their copies
    started. ``size <= 0`` draws each batch when it is consumed."""
    device = torch.device(device)
    if device.type == 'cuda':
        copier = PinnedCopier(device)
        put, take = copier.put, copier.take
    elif device.type == 'cpu':
        def put(batch):
            tensors, rebuild = _as_tensors(batch)
            return rebuild(tensors)

        def take(batch):
            return batch
    else:
        raise ValueError('prefetch_to_device copies to cuda or cpu, not %s' % device)

    it = iter(iterator)
    if size <= 0:   # no lookahead: host draws happen exactly at consumption
        for batch in it:
            yield take(put(batch))
        return
    queue = collections.deque()
    for batch in it:
        queue.append(put(batch))
        if len(queue) == size:
            break
    while queue:
        out = queue.popleft()
        for batch in it:
            queue.append(put(batch))
            break
        yield take(out)
