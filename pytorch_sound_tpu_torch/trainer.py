"""Training runtime: ``forward() -> (loss, meta)`` becomes a full loop.

Counterpart of ``pytorch_sound_tpu/trainer.py`` in torch idiom: the model is
an ``nn.Module`` whose parameters the trainer updates in place with a
``torch.optim`` optimizer, on an explicit device. Kept from the JAX trainer:
LogType-typed console (and, on request, tensorboard) logging, the
NaN/Inf-loss update skip, value-then-global-norm gradient clipping with the
JAX formula, an optional per-step scheduler, validation with best-loss
tracking, the infinite dataset repeat that raises on an empty dataset, the
bootstrap's lazy first batch, the device prefetch (``prefetch_size``
batches drawn ahead and copied to the card from pinned memory on a side
stream, ``parallel.prefetch_to_device``), and checkpoints at the JAX layout
(``<save_dir>/models/<prefix>/<ModelClass>/step_%06d.chkpt`` plus
``<prefix>/<ModelClass>.best.chkpt``), resumed from the highest step in a
file name.

A resumed run is the uninterrupted run, bit for bit, at any prefetch size
and any loader ``num_workers`` (with workers, where the loader's crops draw
nothing from numpy). The lookahead has drawn batches that no step has
taken yet, and their draws moved the numpy stream and the loader. So a
checkpoint holds, per dataset, the loader's position after the last batch a
step took (``state_dict`` of the port's ``SpeechDataLoader``) and the numpy
state before each draw still in flight; a resume puts the loader back there
and draws those batches again, each from its own numpy state, before it
restores the numpy state and the trainer's torch generator (``self.rng``)
as they stood at the save. The file format is the port's own: ``torch.save``
of state dicts. Also as in the JAX trainer: ``remat`` (the forward's
activations recomputed in the backward pass, by
``torch.utils.checkpoint``), a ``torch.profiler`` window over
``profile_steps`` written under ``profile_dir``, and the tensorboard image
and plot channels (``utils/plots.py``, where matplotlib is installed).

Data parallelism: pass ``mesh``, a ``DeviceMesh`` with a 'data' axis
(``parallel.make_mesh()``), in every rank's process (one per card, under
``torchrun``). Each rank's datasets yield that rank's rows of the global
batch: its own shard of the meta rows, as the recipes load them, or
``parallel.local_batches`` of global batches. The parameters and buffers
are broadcast from rank 0 once, after ``init_params`` and the resume, so
ranks that built their modules from other seeds agree. After the backward
pass each gradient becomes its mean over the 'data' ranks, weighted by the
ranks' rows (one all-reduce of all gradients, flattened), before the clip:
the gradient of the global batch's mean loss, which the JAX mesh step
computes. That holds where the loss is a plain mean over rows; a loss
divided by a count that depends on the data (a masked sum over its valid
frames) weighs each rank by its rows instead. The NaN guard decides on the
mean loss over ranks, one all-reduce before the backward pass, so every
rank skips or steps together; logged scalars and validation losses are
such means too, so every rank agrees on the best loss. Only rank 0 writes
checkpoints, which hold every rank's loader position and in-flight numpy
states: a resume gives each rank its own, and is the uninterrupted run bit
for bit per rank. ``save_dir`` must be one directory that every rank sees.
With one rank the mesh path computes what the path without one does, bit
for bit.

Subclass contract::

    class MyTrainer(Trainer):
        def forward(self, *batch, is_logging=False):
            out = self.model(batch[0])
            loss = ...
            meta = {'loss': (loss, LogType.SCALAR)} if is_logging else {}
            return loss, meta
"""

import collections
import enum
import glob
import itertools
import os
import re
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from pytorch_sound_tpu_torch.parallel.prefetch import prefetch_to_device
from pytorch_sound_tpu_torch.utils.commons import log
from pytorch_sound_tpu_torch.utils.plots import imshow_to_buf, plot_to_buf
from pytorch_sound_tpu_torch.utils.tensor import to_numpy

SAMPLE_RATE = 22050


class LogType(enum.Enum):
    SCALAR: int = 1
    IMAGE: int = 2
    ENG: int = 3
    AUDIO: int = 4
    PLOT: int = 5
    TEXT: int = 6


def adamw(params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` at ``optax.adamw``'s defaults: weight decay 1e-4
    (torch's own default is 1e-2) on every parameter, eps 1e-8."""
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def adam(params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """``torch.optim.Adam`` at ``optax.adam``'s defaults. Its update,
    ``lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``, is optax's
    ``lr * m_hat / (sqrt(v_hat) + eps)`` (``eps_root`` 0) written out."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def clip_grads(params: Iterable[torch.nn.Parameter], grad_clip: float = 0.0,
               grad_norm: float = 0.0):
    """Clip gradients in place: by value to [-grad_clip, grad_clip], then by
    global norm with the JAX formula ``min(1, grad_norm / (norm + 1e-12))``
    (``clip_grad_norm_`` adds 1e-6). A zero turns either clip off."""
    grads = [p.grad for p in params if p.grad is not None]
    if grad_clip:
        for g in grads:
            g.clamp_(-grad_clip, grad_clip)
    if grad_norm and grads:
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        scale = torch.clamp(grad_norm / (norm + 1e-12), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))


class Trainer:
    """Generalized training helper: override :meth:`forward`, call :meth:`run`.

    Args mirror the JAX trainer:
        model: an ``nn.Module``, moved to ``device``
        optimizer: a ``torch.optim`` optimizer over the model's parameters
        train_dataset / valid_dataset: iterables of batches (lists of arrays
            or tensors), repeated forever
        max_step / valid_max_step / save_interval / log_interval: loop control
        save_dir / save_prefix: checkpoint and log layout
        grad_clip / grad_norm: value clip then global-norm clip
        pretrained_path: warm-start checkpoint (model weights only)
        sr: sampling rate for audio logging
        scheduler: optional ``fn(step) -> scale`` of the learning rate, run
            as a ``LambdaLR`` stepped after every update
        seed: seeds ``np.random`` and the trainer's ``torch.Generator``
            (``self.rng``); both states go into checkpoints
        device: where batches and models live; 'cuda' raises without a card
        prefetch_size: batches drawn ahead of the step and copied to the
            device meanwhile (pinned memory, a side stream); 0 draws each
            batch when its step takes it
        tensorboard: also write tensorboard event files under
            ``<save_dir>/logs/<prefix>`` when ``torch.utils.tensorboard``
            imports. Off by default: that import loads TensorFlow where it is
            installed, and TensorFlow's converter imports JAX.
        profile_dir / profile_steps: when ``profile_dir`` is set, a
            ``torch.profiler`` session (CPU, and CUDA activity on a CUDA
            device) runs from the start of step ``profile_steps[0]`` to the
            start of step ``profile_steps[1]`` (or the end of the run) and
            writes its Chrome trace to
            ``<profile_dir>/steps_<first>_<last>.pt.trace.json``
        remat: run :meth:`forward` under ``torch.utils.checkpoint`` (not
            reentrant), as the JAX trainer wraps its loss in
            ``jax.checkpoint``: the same gradients, the activations
            recomputed in the backward pass instead of kept. One checkpoint
            around the whole forward recomputes them all at once, so the
            peak memory need not fall
        mesh: a ``DeviceMesh`` with a 'data' axis for data-parallel training
            (see the module docstring); its device type is ``device``'s
    """

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 train_dataset, valid_dataset, max_step: int, valid_max_step: int,
                 save_interval: int, log_interval: int, save_dir: str,
                 save_prefix: str = 'save', grad_clip: float = 0.0,
                 grad_norm: float = 0.0, pretrained_path: str = None, sr: int = None,
                 scheduler: Optional[Callable[[int], float]] = None,
                 seed: int = None, device: Union[str, torch.device] = 'cuda',
                 prefetch_size: int = 2, tensorboard: bool = False,
                 profile_dir: str = None, profile_steps: Tuple[int, int] = (10, 20),
                 remat: bool = False, mesh=None):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "available; pass device='cpu' for the CPU path")
        self.mesh = mesh
        self._group, self.rank, self.world = None, 0, 1
        if mesh is not None:
            self._group, self.rank, self.world = _data_group(mesh, self.device)
        self.pretrained_path = pretrained_path
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.scheduler = (torch.optim.lr_scheduler.LambdaLR(optimizer, scheduler)
                          if scheduler is not None else None)

        self.prefetch_size = prefetch_size
        self.train_dataset = self._stream(train_dataset)
        self.valid_dataset = self._stream(valid_dataset)

        self.step = 0
        self.sr = sr if sr else SAMPLE_RATE
        self.max_step = max_step
        self.save_interval = save_interval
        self.log_interval = log_interval
        self.save_dir = save_dir
        self.save_prefix = save_prefix
        self.grad_clip = grad_clip
        self.grad_norm = grad_norm
        self.valid_max_step = valid_max_step
        self.remat = remat
        self.profile_dir = profile_dir
        self.profile_steps = tuple(profile_steps)
        self._profiler = None
        self.profile_trace = None

        self.log_dir = os.path.join(save_dir, 'logs', self.save_prefix)
        self.model_dir = os.path.join(save_dir, 'models')
        os.makedirs(self.model_dir, exist_ok=True)
        os.makedirs(self.log_dir, exist_ok=True)
        self.writer = _make_writer(self.log_dir) if tensorboard and self.rank == 0 else None

        self.seed = seed if seed else int(np.random.randint(np.iinfo(np.int32).max))
        np.random.seed(self.seed)
        self.rng = torch.Generator().manual_seed(self.seed)

        self._initialized = False
        self._pending_batch = None
        self.best_valid_loss = float(np.finfo(np.float32).max)
        self.cur_best_valid_loss = self.best_valid_loss
        self._step_times = []
        self._warned_channels = set()

    # ------------------------------------------------------------------ user API

    def forward(self, *inputs, is_logging: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Tuple[Any, LogType]]]:
        """Loss of one batch (on ``self.device``) through ``self.model``.

        :returns: (scalar loss, meta dict of name -> (value, LogType))
        """
        raise NotImplementedError('implement forward() in your Trainer subclass')

    def init_params(self, batch):
        """Called once, with the first batch, before a resume. A torch
        module holds its parameters from construction, so the default only
        logs their count; override to warm-start."""
        n_params = sum(p.numel() for p in self.model.parameters())
        log('Model {} was loaded. Total {} params.'.format(
            type(self.model).__name__, n_params))

    # ------------------------------------------------------------------ run loop

    def run(self) -> float:
        try:
            # resume before the loop range is computed: the newest checkpoint
            # sets self.step
            self._bootstrap()
            for i in range(self.step + 1, self.max_step + 1):
                self.step = i
                if i % self.save_interval == 1:
                    log('------------- TRAIN step : %d -------------' % i)
                self.train(i)
                if i % self.save_interval == 0:
                    log('------------- VALID step : %d -------------' % i)
                    self.validate(i)
                    self.save(i)
        except KeyboardInterrupt:
            log('Train is canceled !!')
        finally:
            self._stop_profile(self.step + 1)
        return self.best_valid_loss

    def _bootstrap(self):
        """Draw one batch, initialise and resume before the loop starts. With
        no checkpoint the batch is kept for step 1; after a resume it predates
        the restored RNG streams and is discarded, so the first resumed step
        draws under the restored state."""
        if self._initialized:
            return
        batch = next(self.train_dataset)
        if not self._ensure_initialized(batch):
            self._pending_batch = batch

    def _ensure_initialized(self, batch) -> bool:
        """First-batch initialisation and checkpoint resume. Returns True when
        a checkpoint was loaded."""
        if self._initialized:
            return False
        self._initialized = True
        self.init_params(batch)
        loaded = self.load()
        if self.step == 0 and self.pretrained_path:
            self.load_pretrained_model()
        if self._group is not None:
            src = dist.get_global_rank(self._group, 0)
            for module in self.replicated_modules():
                for t in itertools.chain(module.parameters(), module.buffers()):
                    dist.broadcast(t.data, src, group=self._group)
        return loaded

    def replicated_modules(self) -> List[torch.nn.Module]:
        """The modules whose parameters and buffers every rank holds whole
        (broadcast from rank 0 at the start under a mesh)."""
        return [self.model]

    # ------------------------------------------------------------------ data parallelism

    def _rows_mean(self, values: List[Any], rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(means, total rows): each scalar's mean over the 'data' ranks,
        weighted by each rank's ``rows``, in fp64; one all-reduce."""
        stats = torch.stack([torch.as_tensor(v.detach() if isinstance(v, torch.Tensor) else v,
                                             dtype=torch.float64, device=self.device).reshape(())
                             for v in values] + [torch.ones((), dtype=torch.float64,
                                                            device=self.device)]) * rows
        dist.all_reduce(stats, group=self._group)
        return stats[:-1] / stats[-1], stats[-1]

    def reduce_loss(self, loss: torch.Tensor, rows: int
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the loss of the global batch, this rank's weight ``rows / all
        rows`` for :meth:`reduce_grads`): under a mesh the row-weighted mean
        of the ranks' losses; without one ``(loss, None)``. The NaN guard
        decides on the first, so that every rank decides alike."""
        if self._group is None:
            return loss, None
        means, total = self._rows_mean([loss], rows)
        return means[0].to(loss.dtype), rows / total

    def reduce_grads(self, params: Iterable[torch.nn.Parameter],
                     weight: Optional[torch.Tensor]):
        """Under a mesh, every gradient of ``params`` becomes the sum over the
        'data' ranks of ``weight`` times it (:meth:`reduce_loss`), in place:
        the gradients flattened into one buffer per dtype, one all-reduce
        each. Without a mesh, nothing."""
        if self._group is None:
            return
        by_dtype = defaultdict(list)
        for p in params:
            if p.grad is not None:
                by_dtype[p.grad.dtype].append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            flat.mul_(weight.to(flat.dtype))
            dist.all_reduce(flat, group=self._group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view(g.shape))
                offset += g.numel()

    def _mean_scalars(self, meta: Dict[str, Tuple[Any, LogType]], rows: int,
                      loss: Optional[torch.Tensor] = None):
        """(loss, meta) with ``loss`` and every SCALAR of ``meta`` the
        row-weighted mean over the 'data' ranks (one all-reduce); as they
        are without a mesh."""
        if self._group is None:
            return loss, meta
        keys = [k for k, (_, t) in meta.items() if t == LogType.SCALAR]
        values = [meta[k][0] for k in keys] + ([] if loss is None else [loss])
        if not values:
            return loss, meta
        means, _ = self._rows_mean(values, rows)
        meta = dict(meta, **{k: (means[i], LogType.SCALAR) for i, k in enumerate(keys)})
        return (None if loss is None else means[-1]), meta

    # ------------------------------------------------------------------ steps

    def _train_step(self, batch, is_logging: bool):
        self.optimizer.zero_grad(set_to_none=True)
        if self.remat:
            loss, meta = torch.utils.checkpoint.checkpoint(
                self.forward, *batch, is_logging=is_logging, use_reentrant=False)
        else:
            loss, meta = self.forward(*batch, is_logging=is_logging)
        loss_all, weight = self.reduce_loss(loss, _rows(batch))
        if bool(torch.isfinite(loss_all)):   # NaN/Inf loss -> skip the update
            loss.backward()
            self.reduce_grads(self.model.parameters(), weight)
            clip_grads(self.model.parameters(), self.grad_clip, self.grad_norm)
            self.optimizer.step()
            if self.scheduler is not None:
                self.scheduler.step()
        return loss_all.detach(), meta

    @torch.no_grad()
    def _eval_step(self, batch):
        return self.forward(*batch, is_logging=True)

    def to_device(self, batch):
        """A batch (list of arrays or tensors) on ``self.device``, for a
        batch from outside the datasets (the loop's batches come through the
        prefetch)."""
        return [torch.as_tensor(x).to(self.device, non_blocking=True) for x in batch]

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ phases

    def _maybe_profile(self, step: int):
        if not self.profile_dir:
            return
        start, end = self.profile_steps
        if step == start and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                activities.append(ProfilerActivity.CUDA)
            self._sync()
            self._profiler = profile(activities=activities)
            self._profiler.start()
            log('profiler trace started -> {}'.format(self.profile_dir))
        elif step == end:
            self._stop_profile(step)

    def _stop_profile(self, step: int):
        """End the profiler session, if one runs, before step ``step``."""
        if self._profiler is None:
            return
        self._sync()
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self.profile_trace = os.path.join(self.profile_dir, 'steps_{:06d}_{:06d}.pt.trace.json'
                                          .format(self.profile_steps[0], step - 1))
        self._profiler.export_chrome_trace(self.profile_trace)
        self._profiler = None
        log('profiler trace stopped -> {}'.format(self.profile_trace))

    def train(self, step: int):
        self._maybe_profile(step)
        log_flag = step % self.log_interval == 0
        if self._pending_batch is not None:   # batch drawn during _bootstrap
            batch, self._pending_batch = self._pending_batch, None
        else:
            batch = next(self.train_dataset)
        self._ensure_initialized(batch)

        t0 = time.perf_counter()
        loss, meta = self._train_step(batch, is_logging=log_flag)
        if log_flag:
            self._sync()
        self._step_times.append(time.perf_counter() - t0)
        if len(self._step_times) > 100:
            self._step_times.pop(0)

        if log_flag:
            loss_host = float(loss)
            if loss_host != loss_host:
                log('{} cur step NAN is occured'.format(step))
                return
            meta = _meta_to_host(self._mean_scalars(meta, _rows(batch))[1])
            meta['steps_per_sec'] = (
                1.0 / (sum(self._step_times) / len(self._step_times)), LogType.SCALAR)
            self.console_log('train', meta, step)
            self.tensorboard_log('train', meta, step)

    def validate(self, step: int):
        if self.valid_dataset is None:
            log('no valid dataset configured; validation skipped')
            return
        loss = 0.0
        stat = defaultdict(float)

        for i in range(self.valid_max_step):
            batch = next(self.valid_dataset)
            self._ensure_initialized(batch)
            batch_loss, meta = self._eval_step(batch)
            batch_loss, meta = self._mean_scalars(meta, _rows(batch), batch_loss)
            loss += float(batch_loss)
            meta = _meta_to_host(meta)
            for key, (value, log_type) in meta.items():
                if log_type == LogType.SCALAR:
                    stat[key] += float(np.asarray(value))
            if i % self.log_interval == 0 or i == self.valid_max_step - 1:
                self.console_log('valid', meta, i + 1)

        loss /= self.valid_max_step
        for key in stat:
            if key != 'loss':
                stat[key] = stat[key] / self.valid_max_step
        stat['loss'] = loss

        if loss < self.best_valid_loss:
            self.best_valid_loss = loss

        msg = 'step {} / total stat'.format(step)
        for key, value in sorted(stat.items()):
            msg += '\t{}: {:.6f}'.format(key, value)
        log(msg)

        if self.writer is not None:
            for key, value in stat.items():
                self.writer.add_scalar('valid/{}'.format(key), value, global_step=step)

    # ------------------------------------------------------------------ checkpoints

    def model_state(self) -> Dict[str, Any]:
        return self.model.state_dict()

    def load_model_state(self, state: Dict[str, Any]):
        self.model.load_state_dict(state)

    def optim_state(self) -> Dict[str, Any]:
        return {'optimizer': self.optimizer.state_dict(),
                'scheduler': self.scheduler.state_dict() if self.scheduler else None}

    def load_optim_state(self, state: Dict[str, Any]):
        self.optimizer.load_state_dict(state['optimizer'])
        if self.scheduler is not None and state['scheduler'] is not None:
            self.scheduler.load_state_dict(state['scheduler'])

    @property
    def save_name(self) -> str:
        return self.save_prefix + '/' + type(self.model).__name__

    def _checkpoint_dir(self) -> str:
        return os.path.join(self.model_dir, self.save_name)

    def load(self, load_optim: bool = True) -> bool:
        save_path = self._checkpoint_dir()
        check_files = glob.glob(os.path.join(save_path, 'step_*.chkpt'))
        if not check_files:
            log('No any checkpoint in {}. Loading network skipped.'.format(save_path))
            return False

        def step_of(path):
            m = re.search(r'step_(\d+)\.chkpt$', path)
            return int(m.group(1)) if m else -1

        latest_file = max(check_files, key=step_of)
        state = torch.load(latest_file, map_location=self.device, weights_only=True)
        self.seed = int(state['seed'])
        self.load_model_state(state['model'])
        if load_optim:
            self.load_optim_state(state['optim'])
        ranks = state.get('ranks', [state])   # the streams of each rank
        if len(ranks) != self.world:
            raise ValueError('checkpoint {} holds the data streams of {} ranks; this run '
                             'has {}'.format(latest_file, len(ranks), self.world))
        mine = ranks[self.rank]
        self._load_data_state(mine.get('data', {}), mine.get('data_in_flight', {}))
        # exact RNG restore, after the in-flight draws are replayed: resumed
        # steps see the streams the uninterrupted run saw after the save
        np.random.set_state(_np_state(mine['np_random']))
        self.rng.set_state(mine['rng'].cpu())
        self.step = int(state['step'])
        log("checkpoint '{}' is loaded. previous step={}".format(latest_file, self.step))
        return True

    def save(self, step: int):
        """Write the step's checkpoint (and the best one, after a new best
        validation loss). Under a mesh every rank's streams are gathered
        into it (``'ranks'``), rank 0 writes, and the ranks meet after."""
        streams = {'train': self.train_dataset, 'valid': self.valid_dataset}
        mine = {
            'np_random': _np_state_dict(np.random.get_state()),
            'rng': self.rng.get_state(),
            'data': {key: s.position for key, s in streams.items()
                     if s is not None and s.position is not None},
            'data_in_flight': {key: [_np_state_dict(st) for st in s.in_flight()]
                               for key, s in streams.items() if s is not None},
        }
        state = {
            'step': step,
            'model': self.model_state(),
            'optim': self.optim_state(),
            'pretrained_step': step,
            'seed': self.seed,
            **mine,
        }
        if self._group is not None:
            ranks = [None] * self.world if self.rank == 0 else None
            dist.gather_object(mine, ranks, dst=dist.get_global_rank(self._group, 0),
                               group=self._group)
            state['ranks'] = ranks
        if self.rank == 0:
            save_path = self._checkpoint_dir()
            os.makedirs(save_path, exist_ok=True)
            torch.save(state, os.path.join(save_path, 'step_{:06d}.chkpt'.format(step)))
            if self.best_valid_loss != self.cur_best_valid_loss:
                torch.save(state, os.path.join(self.model_dir, self.save_name + '.best.chkpt'))
        self.cur_best_valid_loss = self.best_valid_loss
        if self._group is not None:
            dist.barrier(group=self._group)
        log('step %d / saved model.' % step)

    def _load_data_state(self, positions: Dict[str, Any], in_flight: Dict[str, List]):
        """Put each dataset back where the checkpoint left it and draw again
        the batches that were in flight (the bootstrap's draws are
        discarded)."""
        for key in ('train', 'valid'):
            stream = getattr(self, key + '_dataset')
            if stream is None:
                continue
            stream.close()
            if key in positions and hasattr(stream.source, 'load_state_dict'):
                stream.source.load_state_dict(positions[key])
            setattr(self, key + '_dataset', self._stream(
                stream.source, [_np_state(st) for st in in_flight.get(key, [])]))

    def load_pretrained_model(self):
        assert os.path.exists(self.pretrained_path), 'You must define pretrained path!'
        state = torch.load(self.pretrained_path, map_location=self.device,
                           weights_only=True)
        self.load_model_state(state['model'])

    # ------------------------------------------------------------------ logging

    def console_log(self, tag: str, meta: Dict[str, Any], step: int):
        msg = '{}\t{:06d} it'.format(tag, step)
        for key, (value, log_type) in sorted(meta.items()):
            if log_type == LogType.SCALAR:
                msg += '\t{}: {:.6f}'.format(key, float(np.asarray(value)))
        log(msg)

    def tensorboard_log(self, tag: str, meta: Dict[str, Any], step: int):
        """Every channel, as the JAX trainer writes it: IMAGE through
        :func:`~pytorch_sound_tpu_torch.utils.plots.imshow_to_buf`, PLOT
        through ``plot_to_buf``. A channel whose helper cannot import (no
        matplotlib) is reported once and skipped."""
        if self.writer is None:
            return
        for key, (value, log_type) in meta.items():
            name = '{}/{}'.format(tag, key)
            try:
                if log_type == LogType.SCALAR:
                    self.writer.add_scalar(name, float(np.asarray(value)), global_step=step)
                elif log_type == LogType.IMAGE:
                    self.writer.add_image(name, imshow_to_buf(value), global_step=step)
                elif log_type == LogType.PLOT:
                    self.writer.add_image(name, plot_to_buf(value), global_step=step)
                elif log_type == LogType.AUDIO:
                    self.writer.add_audio(name, np.asarray(value), global_step=step,
                                          sample_rate=self.sr)
                elif log_type == LogType.TEXT:
                    self.writer.add_text(name, value, global_step=step)
            except ImportError as e:
                if name not in self._warned_channels:
                    self._warned_channels.add(name)
                    log('tensorboard channel {} unavailable: {!r}'.format(name, e))

    # ------------------------------------------------------------------ data

    def _stream(self, source, replay=()):
        if source is None:
            return None
        return _DeviceStream(source, self.prefetch_size, self.device, replay)

    @staticmethod
    def repeat(iterable):
        """Iterate ``iterable`` forever; raise if a pass yields nothing."""
        while True:
            yielded = False
            for x in iterable:
                yielded = True
                yield x
            if not yielded:   # an empty dataset would otherwise spin forever
                raise ValueError('dataset yielded no batches — is the split empty?')


class _DeviceStream:
    """One dataset's batches on the trainer's device, drawn ahead by the
    prefetch, with what a checkpoint needs to draw the ones in flight again:
    per batch drawn and not yet taken, the numpy state before its draw, and
    the source's position after the last batch taken (None for a source
    without ``state_dict``).

    ``replay`` holds numpy states of batches to draw first, each from its
    state, right away (a resume)."""

    def __init__(self, source, size: int, device: torch.device, replay=()):
        self.source = source
        self._stateful = hasattr(source, 'state_dict')
        self.position = source.state_dict() if self._stateful else None
        self._host = Trainer.repeat(source)
        self._drawn = collections.deque()
        ready = []
        for np_state in replay:
            np.random.set_state(np_state)
            ready.append(self._draw())
        self._it = prefetch_to_device(itertools.chain(ready, self._draws()), size, device)

    def _draw(self):
        before = np.random.get_state()
        batch = next(self._host)
        self._drawn.append((before, self.source.state_dict() if self._stateful else None))
        return batch

    def _draws(self):
        while True:
            yield self._draw()

    def __next__(self):
        batch = next(self._it)
        _, self.position = self._drawn.popleft()
        return batch

    def in_flight(self) -> List[tuple]:
        """The numpy state before each draw not yet taken, oldest first."""
        return [before for before, _ in self._drawn]

    def close(self):
        """Stop the prefetch and the source's iteration (its worker threads)."""
        self._it.close()
        self._host.close()


def _data_group(mesh, device: torch.device):
    """(group, rank, world) of the 'data' axis of ``mesh``, whose other axes
    must have one rank each and whose device type must be ``device``'s."""
    names = tuple(mesh.mesh_dim_names or ())
    if 'data' not in names:
        raise ValueError('the trainer reduces over a mesh axis named "data"; this mesh '
                         'has {}'.format(names))
    if any(mesh.size(i) > 1 for i, n in enumerate(names) if n != 'data'):
        raise NotImplementedError('mesh axes other than "data" (tensor parallelism) are not '
                                  'ported yet (ROADMAP.md section 1): {}'.format(mesh))
    if mesh.device_type != device.type:
        raise ValueError('a {} mesh for a trainer on {}'.format(mesh.device_type, device))
    group = mesh.get_group('data')
    return group, dist.get_rank(group), dist.get_world_size(group)


def _rows(batch) -> int:
    """The rows of a batch: its first field's leading size."""
    return int(batch[0].shape[0])


def _np_state_dict(st) -> Dict[str, Any]:
    """numpy's global RNG state as a checkpoint entry."""
    return {'keys': torch.from_numpy(st[1].astype(np.int64)), 'pos': int(st[2]),
            'has_gauss': int(st[3]), 'cached': float(st[4])}


def _np_state(st: Dict[str, Any]) -> tuple:
    return ('MT19937', st['keys'].cpu().numpy().astype(np.uint32), int(st['pos']),
            int(st['has_gauss']), float(st['cached']))


def _meta_to_host(meta: Dict[str, Tuple[Any, LogType]]) -> Dict[str, Tuple[Any, LogType]]:
    """Meta values as host numpy."""
    return {k: (to_numpy(v) if isinstance(v, torch.Tensor) else v, t)
            for k, (v, t) in meta.items()}


def _make_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:      # no tensorboard package -> console-only logging
        return None
    return SummaryWriter(log_dir=log_dir, flush_secs=10)
