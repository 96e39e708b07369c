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
of state dicts. Not ported yet: multi-device meshes, rematerialisation, the
profiler window (``trainer.py:313`` of the JAX package), and the tensorboard
image and plot channels (``utils/plots.py``).

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

from pytorch_sound_tpu_torch.parallel.prefetch import prefetch_to_device
from pytorch_sound_tpu_torch.utils.commons import log
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
    """

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 train_dataset, valid_dataset, max_step: int, valid_max_step: int,
                 save_interval: int, log_interval: int, save_dir: str,
                 save_prefix: str = 'save', grad_clip: float = 0.0,
                 grad_norm: float = 0.0, pretrained_path: str = None, sr: int = None,
                 scheduler: Optional[Callable[[int], float]] = None,
                 seed: int = None, device: Union[str, torch.device] = 'cuda',
                 prefetch_size: int = 2, tensorboard: bool = False):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "available; pass device='cpu' for the CPU path")
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

        self.log_dir = os.path.join(save_dir, 'logs', self.save_prefix)
        self.model_dir = os.path.join(save_dir, 'models')
        os.makedirs(self.model_dir, exist_ok=True)
        os.makedirs(self.log_dir, exist_ok=True)
        self.writer = _make_writer(self.log_dir) if tensorboard else None

        self.seed = seed if seed else int(np.random.randint(np.iinfo(np.int32).max))
        np.random.seed(self.seed)
        self.rng = torch.Generator().manual_seed(self.seed)

        self._initialized = False
        self._pending_batch = None
        self.best_valid_loss = float(np.finfo(np.float32).max)
        self.cur_best_valid_loss = self.best_valid_loss
        self._step_times = []

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
        return loaded

    # ------------------------------------------------------------------ steps

    def _train_step(self, batch, is_logging: bool):
        self.optimizer.zero_grad(set_to_none=True)
        loss, meta = self.forward(*batch, is_logging=is_logging)
        if bool(torch.isfinite(loss)):       # NaN/Inf loss -> skip the update
            loss.backward()
            clip_grads(self.model.parameters(), self.grad_clip, self.grad_norm)
            self.optimizer.step()
            if self.scheduler is not None:
                self.scheduler.step()
        return loss.detach(), meta

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

    def train(self, step: int):
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
            meta = _meta_to_host(meta)
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
        self._load_data_state(state.get('data', {}), state.get('data_in_flight', {}))
        # exact RNG restore, after the in-flight draws are replayed: resumed
        # steps see the streams the uninterrupted run saw after the save
        np.random.set_state(_np_state(state['np_random']))
        self.rng.set_state(state['rng'].cpu())
        self.step = int(state['step'])
        log("checkpoint '{}' is loaded. previous step={}".format(latest_file, self.step))
        return True

    def save(self, step: int):
        streams = {'train': self.train_dataset, 'valid': self.valid_dataset}
        state = {
            'step': step,
            'model': self.model_state(),
            'optim': self.optim_state(),
            'pretrained_step': step,
            'seed': self.seed,
            'np_random': _np_state_dict(np.random.get_state()),
            'rng': self.rng.get_state(),
            'data': {key: s.position for key, s in streams.items()
                     if s is not None and s.position is not None},
            'data_in_flight': {key: [_np_state_dict(st) for st in s.in_flight()]
                               for key, s in streams.items() if s is not None},
        }
        save_path = self._checkpoint_dir()
        os.makedirs(save_path, exist_ok=True)
        torch.save(state, os.path.join(save_path, 'step_{:06d}.chkpt'.format(step)))

        if self.best_valid_loss != self.cur_best_valid_loss:
            torch.save(state, os.path.join(self.model_dir, self.save_name + '.best.chkpt'))
            self.cur_best_valid_loss = self.best_valid_loss

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
        """Scalars, audio and text; image and plot channels need plotting
        helpers the port does not carry yet and are not written."""
        if self.writer is None:
            return
        for key, (value, log_type) in meta.items():
            name = '{}/{}'.format(tag, key)
            if log_type == LogType.SCALAR:
                self.writer.add_scalar(name, float(np.asarray(value)), global_step=step)
            elif log_type == LogType.AUDIO:
                self.writer.add_audio(name, np.asarray(value), global_step=step,
                                      sample_rate=self.sr)
            elif log_type == LogType.TEXT:
                self.writer.add_text(name, value, global_step=step)

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
