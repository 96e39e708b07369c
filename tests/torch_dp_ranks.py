"""Rank bodies of the port's multi-rank CPU tests (``test_torch_parallel.py``,
``test_torch_trainer_dp.py``). Each runs in a process of its own under
``parallel.spawn_ranks`` (gloo over a file store), so this module imports
torch and the port, never JAX: the JAX references are computed in the
pytest process and handed over as numpy arrays."""

import itertools
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pytorch_sound_tpu_torch.examples.hifi_gan import HiFiGANTrainer
from pytorch_sound_tpu_torch.models import build_model
from pytorch_sound_tpu_torch.parallel import local_batch, local_batches, make_mesh
from pytorch_sound_tpu_torch.parallel.prefetch import prefetch_to_device
from pytorch_sound_tpu_torch.parallel.ring_attention import ring_attention
from pytorch_sound_tpu_torch.trainer import LogType, Trainer, adamw

GAN_LR = 2e-4
TINY_GEN = ('hifi_gan_v3', {'upsample_initial_channel': 32})


class TinyNet(nn.Module):
    """tests/test_trainer.py's TinyNet in torch: Dense(8), relu, Dense(1)."""

    def __init__(self, dim: int = 8):
        super().__init__()
        self.l1 = nn.Linear(4, dim)
        self.l2 = nn.Linear(dim, 1)

    def forward(self, x):
        return self.l2(torch.relu(self.l1(x)))


class Recording:
    """Keeps every scalar the trainer logs: (tag, step, {name: value})."""

    def console_log(self, tag, meta, step):
        self.logged.append((tag, step, {k: float(np.asarray(v)) for k, (v, t) in meta.items()
                                        if t == LogType.SCALAR and k != 'steps_per_sec'}))
        super().console_log(tag, meta, step)


class RegressionTrainer(Recording, Trainer):
    def forward(self, x, y, is_logging=False):
        loss = torch.mean((self.model(x)[..., 0] - y) ** 2)
        return loss, ({'loss': (loss, LogType.SCALAR)} if is_logging else {})


class GANTrainer(Recording, HiFiGANTrainer):
    pass


def regression_trainer(save_dir, train, valid, state=None, seed=11, mesh=None, lr=3e-2,
                       **kw):
    """TinyNet under Adam at ``lr`` (optax.adam's formula), weights from
    ``state`` (else from ``torch.manual_seed(seed + rank)``: ranks differ
    until the broadcast)."""
    torch.manual_seed(seed + (dist.get_rank() if dist.is_initialized() else 0))
    model = TinyNet()
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    kw.setdefault('save_interval', 10 ** 9)
    kw.setdefault('log_interval', 1)
    t = RegressionTrainer(model, torch.optim.Adam(model.parameters(), lr=lr), train, valid,
                          valid_max_step=kw.pop('valid_max_step', 1), save_dir=save_dir,
                          save_prefix='reg', seed=seed, device='cpu', mesh=mesh, **kw)
    t.logged = []
    return t


def gan_trainer(save_dir, state=None, mesh=None, **kw):
    """The tiny HiFi-GAN of tests/test_torch_hifigan_training.py (v3 at 32
    channels, the small critics, the cuDNN route) at the recipe's AdamW."""
    gen = build_model(TINY_GEN[0], extra_kwargs=TINY_GEN[1])
    mpd, msd = build_model('hifi_gan_mpd_small'), build_model('hifi_gan_msd_small')
    t = GANTrainer(gen, mpd, msd, adamw(gen.parameters(), GAN_LR, 0.8, 0.99),
                   adamw(itertools.chain(mpd.parameters(), msd.parameters()), GAN_LR, 0.8, 0.99),
                   kw.pop('train', None), None, max_step=kw.pop('max_step', 1), valid_max_step=1,
                   save_interval=10 ** 9, log_interval=1, save_dir=save_dir, save_prefix='gan',
                   seed=13, device='cpu', mesh=mesh, **kw)
    if state is not None:
        t.load_model_state({key: {k: torch.from_numpy(v) for k, v in sd.items()}
                            for key, sd in state.items()})
    t.logged = []
    return t


def numpy_state(module_state):
    """A (nested) state dict as numpy arrays."""
    if isinstance(module_state, dict):
        return {k: numpy_state(v) for k, v in module_state.items()}
    return module_state.detach().cpu().numpy().copy()


# ------------------------------------------------------------------ parallel

def prefetch_rows(batches):
    """This rank's prefetched rows of each global batch."""
    mesh = make_mesh()
    return [[x.numpy() for x in b] for b in prefetch_to_device(
        iter(local_batches(batches, mesh)), size=2, device='cpu')]


def ring(q, k, v):
    """Ring attention over 'seq' axes of 4, 2 and 1 ranks in one job of 4
    (meshes (4,), (2, 2) and (4, 1): the smaller rings are subgroups, whose
    peers are other global ranks), each strategy on this rank's shard of the
    sequence: {(ring size, local): (N, H, T / size, D)}."""
    rank, out = dist.get_rank(), {}
    for size in (4, 2, 1):
        mesh = make_mesh((4,), ('seq',)) if size == 4 else make_mesh((4 // size, size),
                                                                     ('dp', 'seq'))
        n, i = q.shape[2] // size, rank % size
        shard = [torch.from_numpy(x[:, :, i * n:(i + 1) * n].copy()) for x in (q, k, v)]
        for local in ('auto', 'dense', 'blockwise'):
            out[size, local] = ring_attention(*shard, mesh, axis='seq', local=local).numpy()
    return out


def call(*fns):
    """Each of ``fns`` (entry points with their arguments bound) in turn on
    this rank, as torchrun would run them: their results."""
    return [fn() for fn in fns]


# ------------------------------------------------------------------ trainer

def regression_run(save_dir, state, batches, valid, max_step):
    """The regression trainer on this rank's rows of the global batches for
    ``max_step`` steps, validating and saving every 5: (params, logged
    scalars, best validation loss)."""
    mesh = make_mesh()
    t = regression_trainer(save_dir, local_batches(batches, mesh),
                           local_batches(valid, mesh), state=state, mesh=mesh,
                           max_step=max_step, save_interval=5, valid_max_step=2)
    best = t.run()
    return numpy_state(t.model.state_dict()), t.logged, best


def regression_grads(save_dir, state, batch):
    """The gradient one regression step takes on this rank's rows of the
    global ``batch``, after the reduction: {split: {name: gradient}} for
    the even split (``local_batch``) and for 3/4 of the rows on rank 0 and
    1/4 on rank 1."""
    mesh = make_mesh()
    rank, n = dist.get_rank(), len(batch[0])
    cut = (0, 3 * n // 4, n)
    out = {}
    for split, rows in (('even', local_batch(batch, mesh)),
                        ('uneven', [a[cut[rank]:cut[rank + 1]] for a in batch])):
        t = regression_trainer(save_dir, None, None, state=state, mesh=mesh, max_step=1)
        rows = t.to_device(rows)
        t._ensure_initialized(rows)
        t._train_step(rows, is_logging=False)
        out[split] = {k: p.grad.numpy().copy() for k, p in t.model.named_parameters()}
    return out


def gan_step(save_dir, state, wav):
    """One HiFi-GAN split step on this rank's rows of ``wav``: (params,
    the logged scalars, the gradients the step took: the critics' of the
    critic phase, the generator's against the updated critics, each the
    mean over ranks)."""
    mesh = make_mesh()
    t = gan_trainer(save_dir, state=state, mesh=mesh,
                    train=[local_batch([wav], mesh)])
    t.run()
    grads = {f: {k: p.grad.numpy().copy() for k, p in m.named_parameters()}
             for f, m in (('gen', t.generator), ('mpd', t.mpd), ('msd', t.msd))}
    return numpy_state(t.model_state()), t.logged[-1][2], grads


def nan_rows(save_dir, state, x, y, gan_state, wav):
    """One step of each trainer whose global batch has NaN rows on rank 1
    only: whether every parameter and the optimizers stayed as they were."""
    mesh = make_mesh()
    t = regression_trainer(save_dir, None, None, state=state, mesh=mesh, max_step=1)
    batch = t.to_device(local_batch([x, y], mesh))
    t._ensure_initialized(batch)
    before = numpy_state(t.model.state_dict())
    loss, _ = t._train_step(batch, is_logging=False)
    after = numpy_state(t.model.state_dict())
    same = all(np.array_equal(before[k], after[k]) for k in before)
    regression = (float(loss), same and not t.optimizer.state)

    g = gan_trainer(save_dir, state=gan_state, mesh=mesh)
    gan_batch = g.to_device(local_batch([wav], mesh))
    g._ensure_initialized(gan_batch)
    before = numpy_state(g.model_state())
    loss, _ = g._train_step(gan_batch, is_logging=False)
    after = numpy_state(g.model_state())
    same = all(np.array_equal(before[f][k], after[f][k]) for f in before for k in before[f])
    return regression, (float(loss), same and not g.gen_optimizer.state
                        and not g.disc_optimizer.state)


def uneven_rows(save_dir, state, batches):
    """Two steps: this rank's own rows of the first batch (the ranks' shares
    differ), then its rows of the second by ``local_batch`` (a straggler
    kept whole): (params, logged losses)."""
    mesh = make_mesh()
    first, second = batches
    rank = dist.get_rank()
    cut = (0, 3, len(first[0]))           # rank 0 takes 3 rows, rank 1 the rest
    mine = [a[cut[rank]:cut[rank + 1]] for a in first]
    t = regression_trainer(save_dir, [mine, local_batch(second, mesh)],
                           None, state=state, mesh=mesh, max_step=2)
    t.run()
    return numpy_state(t.model.state_dict()), [m['loss'] for _, _, m in t.logged]


class RankStream:
    """Batches drawn from the global numpy stream, rank r drawing r extra
    numbers a batch, so that the ranks' numpy states part."""

    def __iter__(self):
        w = np.arange(4.0) + 1
        for _ in range(4):
            x = np.random.standard_normal((4, 4)).astype(np.float32)
            np.random.standard_normal(dist.get_rank())
            yield [x, (x @ w).astype(np.float32)]


def resume(base):
    """6 steps with checkpoints at 3 and 6, then a fresh run from the step-3
    checkpoint alone to step 6, in the same ranks: (params and logged
    scalars of both runs, whether the step-6 checkpoints hold the same
    model and every rank's same streams)."""
    mesh = make_mesh()
    rank = dist.get_rank()
    first, second = os.path.join(base, 'first'), os.path.join(base, 'second')
    valid = [[np.ones((4, 4), np.float32), np.ones(4, np.float32)]]
    runs = []
    for save_dir, seed in ((first, 11), (second, 99)):
        if save_dir == second and rank == 0:
            ckpt = os.path.join('models', 'reg', 'TinyNet')
            os.makedirs(os.path.join(second, ckpt))
            shutil.copy(os.path.join(first, ckpt, 'step_000003.chkpt'),
                        os.path.join(second, ckpt))
        dist.barrier()
        t = regression_trainer(save_dir, RankStream(), valid, seed=seed, mesh=mesh,
                               max_step=6, save_interval=3, prefetch_size=2)
        t.run()
        runs.append((numpy_state(t.model.state_dict()), t.logged))
    same = None
    if rank == 0:
        a, b = (torch.load(os.path.join(d, 'models', 'reg', 'TinyNet', 'step_000006.chkpt'),
                           weights_only=True) for d in (first, second))
        same = (all(torch.equal(a['model'][k], b['model'][k]) for k in a['model'])
                and len(a['ranks']) == 2 and _equal(a['ranks'], b['ranks'])
                and not _equal(a['ranks'][0]['np_random'], a['ranks'][1]['np_random']))
    return runs, same


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b
