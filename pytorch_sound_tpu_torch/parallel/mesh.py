"""Process groups and device meshes: the port's counterpart of
``pytorch_sound_tpu/parallel/mesh.py``.

JAX runs one process per host and puts the host's devices on a
``jax.sharding.Mesh``; GSPMD inserts the collectives. PyTorch runs one
process per card (``torchrun --nproc_per_node=N``), each process a rank of
the default process group, and a
``torch.distributed.device_mesh.DeviceMesh`` names the ranks' axes. The
collectives are written out where they are needed (the trainer's gradient
mean, ring attention's exchange).

- :func:`init_distributed` reads torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``), pins ``cuda:LOCAL_RANK`` and starts the
  default group: NCCL on a card, gloo on the CPU. A missing card or NCCL
  raises; no other backend or device is picked instead.
  :func:`process_rank` reads the same without starting a group, for work
  that only splits its input over the ranks.
- :func:`make_mesh` builds the mesh over the ranks of that group.
- :func:`spawn_ranks` runs a function in ``world`` fresh processes over a
  ``file://`` store, as the CPU tests and ``chip_smoke.py`` do: a
  launcher for one host with a deadline.

A torchrun job's group keeps PyTorch's default timeout, which long
checkpoint writes on rank 0 fit in; the groups :func:`spawn_ranks` starts
time out after ``SPAWN_TIMEOUT_S``, so a collective that one rank never
joins fails a test or a check instead of hanging it.
"""

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
import warnings
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

SPAWN_TIMEOUT_S = 60.0
# gloo's TCP rendezvous on one host now and then fails with "Connection
# closed by peer" while other groups form beside it; spawn_ranks forms a
# group that failed so again, on a fresh store, up to this many times
RENDEZVOUS_ATTEMPTS = 3


def _local_device(device: Union[str, torch.device]) -> torch.device:
    """``device``, where a CUDA one under torchrun becomes
    ``cuda:LOCAL_RANK`` and is made the current device (without that,
    every rank's NCCL communicator lands on card 0); a missing card
    raises."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available; "
                           "pass device='cpu' for the CPU path")
    if device.type == 'cuda' and 'WORLD_SIZE' in os.environ:
        device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', os.environ['RANK'])))
        torch.cuda.set_device(device)
    return device


def process_rank(device: Union[str, torch.device] = 'cuda') -> Tuple[int, int, torch.device]:
    """``(rank, world, device)`` of this process, starting no group: the
    running default group's rank and size where there is one, else
    torchrun's ``RANK`` and ``WORLD_SIZE``, else ``(0, 1)``; the device as
    :func:`init_distributed` pins it."""
    device = _local_device(device)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), device
    return int(os.environ.get('RANK', 0)), int(os.environ.get('WORLD_SIZE', 1)), device


def init_distributed(device: Union[str, torch.device] = 'cuda') -> Tuple[int, int, torch.device]:
    """Join the job torchrun started: returns ``(rank, world, device)``.

    Where ``WORLD_SIZE`` is not set this is one process: nothing is
    initialised and ``device`` comes back as given (``(0, 1, device)``).
    Otherwise a CUDA ``device`` becomes ``cuda:LOCAL_RANK``, made current,
    and the default group starts over ``env://`` with PyTorch's default
    timeout, NCCL on a card and gloo on the CPU, unless it already runs
    (:func:`spawn_ranks` starts it). A card without NCCL raises."""
    device = _local_device(device)
    if 'WORLD_SIZE' not in os.environ:
        return 0, 1, device
    if not dist.is_initialized():
        if device.type == 'cuda' and not dist.is_nccl_available():
            raise RuntimeError('this torch has no NCCL: the ranks on %s cannot join' % device)
        dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                                init_method='env://', rank=int(os.environ['RANK']),
                                world_size=int(os.environ['WORLD_SIZE']))
    return dist.get_rank(), dist.get_world_size(), device


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ('data',),
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the ranks of the default group.

    Default: every rank on one 'data' axis. ``shape`` must multiply to the
    world size, as JAX's mesh must cover its devices, e.g.
    ``make_mesh((2, 2), ('data', 'model'))`` on 4 ranks. ``device_type``
    defaults to 'cuda' where the default group runs NCCL and 'cpu'
    otherwise; name 'cuda' for gloo ranks that work on a card."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs the default process group: call '
                           'init_distributed() under torchrun, or spawn_ranks()')
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(shape)
    if int(np.prod(shape)) != world:
        raise ValueError('mesh shape {} does not cover {} ranks'.format(shape, world))
    if len(axis_names) != len(shape):
        raise ValueError('{} axis names for a mesh of shape {}'.format(len(axis_names), shape))
    if device_type is None:
        device_type = 'cuda' if 'nccl' in str(dist.get_backend()) else 'cpu'
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def recipe_data_parallel(use_mesh: bool, device: Union[str, torch.device], batch_size: int):
    """A recipe's ``main`` under ``use_mesh``: ``(mesh, (rank, world), device,
    rows a rank)``. Joins torchrun's job (:func:`init_distributed`); the
    global ``batch_size`` must divide over the ranks, and each rank loads
    ``batch_size // world`` rows of its shard of the metas. One process, or
    ``use_mesh`` False, is the one-card path: no mesh, every row."""
    if not use_mesh:
        return None, (0, 1), torch.device(device), batch_size
    rank, world, device = init_distributed(device)
    if batch_size % world:
        raise ValueError('batch_size {} does not divide over {} ranks'.format(batch_size, world))
    mesh = make_mesh(device_type=device.type) if dist.is_initialized() else None
    return mesh, (rank, world), device, batch_size // world


def _rank_main(fn, rank, world, backend, device_type, store, results, args):
    """One rank of :func:`spawn_ranks`: torchrun's environment, the default
    group over the file store, ``fn(*args)``; its result or its traceback
    goes back through ``results``, tagged 'ok', 'rendezvous' (the group
    did not form) or 'error'."""
    stage = 'error'
    try:
        local = rank
        if device_type == 'cuda':
            if not torch.cuda.is_available():
                raise RuntimeError('a cuda rank needs a CUDA device; none is available')
            local = rank % torch.cuda.device_count()
            torch.cuda.set_device(local)
        else:
            torch.set_num_threads(1)           # as torchrun's OMP_NUM_THREADS=1
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local),
                          LOCAL_WORLD_SIZE=str(world))
        stage = 'rendezvous'
        dist.init_process_group(backend, init_method='file://' + store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
        stage = 'error'
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, 'ok', out))
    except BaseException:     # reported to the parent, which raises it
        results.put((rank, stage, traceback.format_exc()))


def spawn_ranks(fn: Callable, world: int, backend: str, device_type: str, *args,
                deadline_s: float = 300.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks, each a fresh process (``spawn``)
    in the default group over a ``file://`` store, with torchrun's
    environment variables set; return the ranks' results in rank order.

    ``fn`` and its arguments and results are pickled (``fn`` by its import
    path). ``device_type`` 'cuda' makes ``cuda:rank % cards`` each rank's
    current device (gloo may put several ranks on one card; NCCL may not);
    'cpu' ranks run one intra-op thread each. Collectives time out after
    ``SPAWN_TIMEOUT_S``; a rank that fails ends the others at once, and
    ranks not done ``deadline_s`` after the start are killed: either way
    this raises. A group that does not form is started again on a fresh
    store, up to ``RENDEZVOUS_ATTEMPTS`` times in all, within the same
    deadline."""
    if backend == 'nccl' and device_type == 'cuda' and world > torch.cuda.device_count():
        raise ValueError('NCCL takes one rank a card: %d ranks, %d cards'
                         % (world, torch.cuda.device_count()))
    end = time.monotonic() + deadline_s
    for attempt in range(1, RENDEZVOUS_ATTEMPTS + 1):
        out, failure, stage = _spawn_once(fn, world, backend, device_type, args, end)
        if failure is None:
            return [out[r] for r in range(world)]
        if stage != 'rendezvous' or attempt == RENDEZVOUS_ATTEMPTS:
            raise RuntimeError('spawn_ranks: ' + failure)
        warnings.warn('spawn_ranks: the group did not form (attempt %d of %d), starting '
                      'the ranks again:\n%s' % (attempt, RENDEZVOUS_ATTEMPTS, failure))


def _spawn_once(fn, world, backend, device_type, args, end):
    """One try of :func:`spawn_ranks`, ending by ``end`` (``time.monotonic``):
    (each rank's result by rank, the first failure or None, the failed
    rank's stage)."""
    ctx = multiprocessing.get_context('spawn')
    tmp = tempfile.mkdtemp(prefix='spawn_ranks_')
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, device_type,
                               os.path.join(tmp, 'store'), results, args))
             for r in range(world)]
    out, failure, stage = {}, None, 'error'
    try:
        for p in procs:
            p.start()
        while len(out) < world and failure is None:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    failure = 'ranks {} exited with codes {}'.format(
                        dead, [procs[r].exitcode for r in dead])
                elif time.monotonic() > end:
                    failure = 'ranks {} not done by the deadline'.format(
                        sorted(set(range(world)) - set(out)))
                continue
            if status == 'ok':
                out[rank] = value
            else:
                failure, stage = 'rank {} failed:\n{}'.format(rank, value), status
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()) if failure is None else 0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out, failure, stage
