"""The device prefetch (``parallel.prefetch_to_device``) on the CPU, and the
trainer's resume under lookahead: a run stopped at step 3 and resumed to
step 6 writes the uninterrupted run's step-6 checkpoint bit for bit, with
the default ``prefetch_size=2``, at loader ``num_workers`` 0 and 2, where
the lookahead crosses epoch boundaries (the next epoch's shuffle is drawn
early) and the loader's threads load ahead of the trainer."""

import numpy as np
import pytest
import torch
from torch import nn

from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.parallel import prefetch_to_device
from pytorch_sound_tpu_torch.trainer import LogType, Trainer


class Counting:
    """Yields batches i = 0 .. n - 1, recording when each is drawn."""

    def __init__(self, n, make):
        self.n, self.make, self.drawn = n, make, []

    def __iter__(self):
        for i in range(self.n):
            self.drawn.append(i)
            yield self.make(i)


@pytest.mark.parametrize('size', [0, 1, 2, 5])
def test_prefetch_order_and_lookahead(size):
    """Batches come in order as tensors; at each yield ``size`` more have
    been drawn (all that is left, near the end); ``size`` 0 draws at
    consumption."""
    src = Counting(6, lambda i: np.full(3, i, np.float32))
    seen = []
    for batch in prefetch_to_device(src, size=size, device='cpu'):
        assert isinstance(batch, torch.Tensor) and batch.dtype == torch.float32
        seen.append(int(batch[0]))
        assert len(src.drawn) == min(6, len(seen) + max(size, 0))
    assert seen == list(range(6))


def test_prefetch_tuple_and_list_batches():
    """A tuple stays a tuple and a list a list, element for element; an
    empty source yields nothing."""
    src = [(np.arange(1), np.int64(0)), [np.zeros((2, 2), np.float64)]]
    out = list(prefetch_to_device(src, size=2, device='cpu'))
    assert type(out[0]) is tuple and type(out[1]) is list
    assert torch.equal(out[0][0], torch.arange(1)) and int(out[0][1]) == 0
    assert out[1][0].dtype == torch.float64 and out[1][0].shape == (2, 2)
    assert list(prefetch_to_device([], size=2, device='cpu')) == []
    with pytest.raises(ValueError, match='cuda or cpu'):
        next(prefetch_to_device(src, size=2, device='meta'))


class Items:
    """Ten (x, y) items; with ``crop`` each draws an offset from numpy, as the
    speech dataset's random crops do."""

    def __init__(self, crop):
        rng = np.random.default_rng(0)
        self.x = rng.standard_normal((10, 6)).astype(np.float32)
        self.crop = crop

    def __len__(self):
        return 10

    def __getitem__(self, i):
        start = np.random.randint(0, 3) if self.crop else 0
        x = self.x[i, start:start + 4]
        return [x, np.float32(x @ (np.arange(4.0) + 1))]


class Regression(Trainer):
    def forward(self, x, y, is_logging=False):
        loss = torch.mean((self.model(x)[..., 0] - y) ** 2)
        return loss, ({'loss': (loss, LogType.SCALAR)} if is_logging else {})


def _run(save_dir, max_step, num_workers, crop):
    np.random.seed(0)
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 1))
    train = SpeechDataLoader(Items(crop), batch_size=3, num_workers=num_workers,
                             is_shuffle=True)
    valid = SpeechDataLoader(Items(crop), batch_size=4, num_workers=num_workers,
                             is_shuffle=True)
    t = Regression(model, torch.optim.Adam(model.parameters(), lr=1e-2), train, valid,
                   max_step=max_step, valid_max_step=2, save_interval=3, log_interval=1,
                   save_dir=str(save_dir), seed=3, device='cpu')
    assert t.prefetch_size == 2
    t.run()
    return torch.load(save_dir / 'models' / 'save' / 'Sequential' / 'step_000006.chkpt',
                      weights_only=True) if max_step == 6 else None


def _same(x, y):
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(_same(u, v) for u, v in zip(x, y))
    if isinstance(x, torch.Tensor):
        return torch.equal(x, y)
    return x == y


@pytest.mark.parametrize('num_workers,crop', [(0, True), (2, False)])
def test_resumed_run_is_the_uninterrupted_run(tmp_path, num_workers, crop):
    """Six steps in one run against three, then a resume to six: the step-6
    checkpoints are equal bit for bit (weights, optimizer, numpy and torch
    generator states, loader positions, the in-flight draws). An epoch is
    four batches, so the two batches in flight cross into the next epoch.
    With worker threads the items draw no crop: the threads' crops come in
    an order that varies between runs, resumed or not."""
    whole = _run(tmp_path / 'a', 6, num_workers, crop)
    _run(tmp_path / 'b', 3, num_workers, crop)
    resumed = _run(tmp_path / 'b', 6, num_workers, crop)
    assert len(whole['data_in_flight']['train']) == 2
    assert _same(whole, resumed)


def test_loader_position_ignores_its_threads_lookahead():
    """With worker threads loading ahead, the loader's position is the one
    after the last batch it yielded, as without them."""
    positions = {}
    for workers in (0, 2):
        np.random.seed(1)
        loader = SpeechDataLoader(Items(False), batch_size=2, num_workers=workers,
                                  is_shuffle=True, prefetch_batches=3)
        it = iter(loader)
        next(it), next(it)
        positions[workers] = loader.state_dict()
        it.close()
    assert positions[0] == positions[2] and len(positions[0]['batches']) == 3
