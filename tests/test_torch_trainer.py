"""The port's Trainer on the CPU with a tiny torch model, mirroring
tests/test_trainer.py:56-197 (loop mechanics, checkpoint layout, resume and
its data stream, clipping, the NaN guard, the scheduler), and its AdamW
against optax.adamw."""

import os

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from pytorch_sound_tpu_torch.trainer import LogType, Trainer, adamw, clip_grads  # noqa: E402


class TinyNet(nn.Module):

    def __init__(self, dim: int = 8):
        super().__init__()
        self.l1 = nn.Linear(4, dim)
        self.l2 = nn.Linear(dim, 1)

    def forward(self, x):
        return self.l2(torch.relu(self.l1(x)))


class RegressionTrainer(Trainer):
    def forward(self, x, y, is_logging=False):
        pred = self.model(x)[..., 0]
        loss = torch.mean((pred - y) ** 2)
        meta = {'loss': (loss, LogType.SCALAR)} if is_logging else {}
        return loss, meta


def make_loader(n_batches=8, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    w = np.arange(4.0) + 1
    data = []
    for _ in range(n_batches):
        x = rng.standard_normal((batch, 4)).astype(np.float32)
        data.append([x, (x @ w).astype(np.float32)])
    return data


def make_trainer(tmp_path, max_step=30, seed=11, cls=RegressionTrainer, lr=3e-2,
                 train=None, **kw):
    kw.setdefault('save_interval', 10)
    kw.setdefault('log_interval', 5)
    torch.manual_seed(seed)
    model = TinyNet()
    return cls(model, torch.optim.Adam(model.parameters(), lr=lr),
               make_loader() if train is None else train, make_loader(n_batches=2),
               max_step=max_step, valid_max_step=2, save_dir=str(tmp_path),
               save_prefix='reg', seed=seed, device='cpu', **kw)


def first_param(t):
    return next(t.model.parameters()).detach().clone()


def test_trainer_learns_and_checkpoints(tmp_path):
    t = make_trainer(tmp_path, max_step=200, save_interval=100)
    best = t.run()
    assert np.isfinite(best)
    ckpt_dir = os.path.join(str(tmp_path), 'models', 'reg', 'TinyNet')
    files = sorted(os.listdir(ckpt_dir))
    assert 'step_000100.chkpt' in files and 'step_000200.chkpt' in files
    assert os.path.exists(os.path.join(str(tmp_path), 'models', 'reg', 'TinyNet.best.chkpt'))
    x, y = (torch.from_numpy(a) for a in make_loader()[0])
    loss0, _ = t.forward(x, y)
    assert loss0.item() < 5.0          # initial mse ~ var(y) ~ 30


class CountingTrainer(RegressionTrainer):
    """Counts executed train steps: a resume must not re-run old ones."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.executed_steps = []

    def train(self, step):
        self.executed_steps.append(step)
        super().train(step)


def test_trainer_resume(tmp_path):
    t1 = make_trainer(tmp_path, max_step=20, cls=CountingTrainer)
    t1.run()
    assert t1.executed_steps == list(range(1, 21))

    # a new trainer resumes from step 20 and executes only steps 21..25
    t2 = make_trainer(tmp_path, max_step=25, seed=99, cls=CountingTrainer)
    t2.run()
    assert t2.step == 25
    assert t2.executed_steps == list(range(21, 26))
    assert t2.seed == t1.seed        # the seed comes from the checkpoint


class StreamRecorder:
    """Loader drawing batches from global np.random, recording each draw."""

    def __init__(self, log, batch=16):
        self.log = log
        self.batch = batch

    def __iter__(self):
        w = np.arange(4.0) + 1
        for _ in range(8):
            x = np.random.standard_normal((self.batch, 4)).astype(np.float32)
            self.log.append(float(x.sum()))
            yield [x, (x @ w).astype(np.float32)]


def _stream_trainer(tmp_path, log, max_step, prefetch_size=2):
    return make_trainer(tmp_path, max_step=max_step, seed=7, train=StreamRecorder(log),
                        save_interval=5, prefetch_size=prefetch_size)


def test_resume_reproduces_data_stream(tmp_path):
    """Interrupt + resume replays the exact data stream of an uninterrupted
    run (np.random and the torch generator are checkpointed), with no
    lookahead and with the default prefetch, whose draws in flight at the
    save are drawn again, each from its own numpy state."""
    for size in (0, 2):
        full_log = []
        _stream_trainer(tmp_path / ('full%d' % size), full_log, 20, size).run()
        assert len(full_log) == 20 + size   # one draw per step, and the lookahead

        part_log = []
        _stream_trainer(tmp_path / ('res%d' % size), part_log, 10, size).run()
        resumed_log = []
        t = _stream_trainer(tmp_path / ('res%d' % size), resumed_log, 20, size)
        t.run()
        assert t.step == 20
        # the bootstrap's draws (one, and the lookahead's) are discarded on
        # resume; the rest equal the draws of steps 11..20 and the lookahead
        np.testing.assert_array_equal(resumed_log[1 + size:], full_log[10:20 + size])
        tf = _stream_trainer(tmp_path / ('full%d' % size), [], 20, size)
        tf._bootstrap()              # reload the finished run's last checkpoint
        torch.testing.assert_close(first_param(t), first_param(tf), atol=1e-6, rtol=0)
        assert torch.equal(t.rng.get_state(), tf.rng.get_state())


def test_trainer_grad_clip(tmp_path):
    t = make_trainer(tmp_path, max_step=5, grad_clip=0.01, grad_norm=0.5)
    t.run()
    assert t.step == 5


def test_clip_grads_matches_jax_formula():
    """Value clip, then the global-norm scale min(1, n / (norm + 1e-12))."""
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    params = [nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    clip_grads(params, grad_clip=1.0, grad_norm=0.5)
    clipped = [np.clip(g, -1.0, 1.0) for g in grads]
    norm = float(optax.global_norm([jnp.asarray(g) for g in clipped]))
    scale = min(1.0, 0.5 / (norm + 1e-12))
    for p, g in zip(params, clipped):
        np.testing.assert_allclose(p.grad.numpy(), g * scale, rtol=1e-6, atol=1e-8)


def test_nan_guard_skips_update(tmp_path):
    class NaNTrainer(RegressionTrainer):
        def forward(self, x, y, is_logging=False):
            loss, meta = super().forward(x, y, is_logging=is_logging)
            return loss * float('nan'), meta

    t = make_trainer(tmp_path, max_step=3, cls=NaNTrainer, lr=1e-2, log_interval=1)
    t._ensure_initialized(make_loader()[0])
    before = first_param(t)
    t.train(1)
    assert torch.equal(before, first_param(t))
    assert not t.optimizer.state        # no optimizer step was taken


def test_scheduler_chained(tmp_path):
    """fn(step) scales the learning rate of update step (0-based), as
    optax.scale_by_schedule does."""
    sched = optax.piecewise_constant_schedule(1.0, {5: 0.1})
    t = make_trainer(tmp_path, max_step=8, scheduler=lambda s: float(sched(s)))
    t.run()
    assert t.step == 8
    assert t.optimizer.param_groups[0]['lr'] == pytest.approx(3e-3)


def test_adamw_matches_optax():
    """adamw(lr, b1=0.8, b2=0.99) equals optax.adamw(lr, b1=0.8, b2=0.99)
    over 3 steps on fixed gradients."""
    rng = np.random.default_rng(9)
    shapes = ((6, 5), (5,), (2, 3, 4))
    p0 = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0 ** -k for s in shapes]
             for k in range(3)]

    params = [nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = adamw(params, 2e-4, b1=0.8, b2=0.99)
    ref_opt = optax.adamw(2e-4, b1=0.8, b2=0.99)
    ref = [jnp.asarray(p) for p in p0]
    state = ref_opt.init(ref)
    for step_grads in grads:
        for p, g in zip(params, step_grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = ref_opt.update([jnp.asarray(g) for g in step_grads], state, ref)
        ref = optax.apply_updates(ref, updates)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=0, atol=1e-7)


def test_empty_dataset_raises(tmp_path):
    t = make_trainer(tmp_path, max_step=2, train=[])
    with pytest.raises(ValueError, match='no batches'):
        t.run()


def test_tensorboard_writer_on_request(tmp_path):
    """tensorboard=True writes event files under <save_dir>/logs/<prefix>;
    the default logs to the console only."""
    assert make_trainer(tmp_path / 'off', max_step=1).writer is None
    t = make_trainer(tmp_path / 'on', max_step=2, log_interval=1, save_interval=2,
                     tensorboard=True)
    t.run()
    t.writer.close()
    log_dir = os.path.join(str(tmp_path / 'on'), 'logs', 'reg')
    assert any(f.startswith('events.out.tfevents') for f in os.listdir(log_dir))
