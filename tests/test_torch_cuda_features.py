"""Feature extraction on a card: the pinned-memory prefetch, the resampler
under TF32, ``extract_features`` against its CPU run, and the trainer's
resume with the device prefetch.

Every test here is marked ``cuda`` and skips without a CUDA device. On a
machine with one:

    python -m pytest --noconftest tests/test_torch_cuda_features.py -q
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

from pytorch_sound_tpu_torch import native
from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
from pytorch_sound_tpu_torch.ops.resample import resample_poly
from pytorch_sound_tpu_torch.parallel import prefetch_to_device
from pytorch_sound_tpu_torch.scripts.preprocess import Processor
from pytorch_sound_tpu_torch.trainer import LogType, Trainer
from pytorch_sound_tpu_torch.utils.wavio import write_wav

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def test_prefetch_delivers_every_batch_intact(card):
    """60 batches of varying shapes through the pinned side-stream copy,
    each consumed by a long kernel on the default stream while later copies
    run: every batch arrives with the host's values (a staging buffer
    refilled before its copy ends, or a tensor freed while the consumer
    reads it, would corrupt one), in order."""
    rng = np.random.default_rng(0)
    host = [(rng.standard_normal((4, 1000 + 997 * (i % 7))).astype(np.float32),
             rng.integers(-2 ** 15, 2 ** 15, 5000 + 13 * i).astype(np.int16))
            for i in range(60)]
    big = torch.randn(2048, 2048, device=card)
    for size in (0, 1, 2, 4):
        for i, (x, q) in enumerate(prefetch_to_device(host, size=size, device=card)):
            assert x.device == card and q.dtype == torch.int16
            for _ in range(3):
                big = torch.tanh(big @ big) * 0.5        # keep the stream busy
            got = (x.cpu().numpy(), q.cpu().numpy())
            assert np.array_equal(got[0], host[i][0]) and np.array_equal(got[1], host[i][1]), \
                (size, i)


def test_resample_is_fp32_exact_under_tf32(card):
    """The resampler's product runs in float64: with TF32 allowed for
    matmuls and convolutions it stays within 2e-6 of the native resampler."""
    x = (0.3 * np.random.default_rng(1).standard_normal((4, 48000))).astype(np.float32)
    ref = np.stack([native.resample(r, 48000, 22050) for r in x])
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        got = resample_poly(torch.from_numpy(x).to(card), 48000, 22050).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert np.abs(got - ref).max() <= 2e-6


@pytest.fixture
def tree(tmp_path):
    rng = np.random.default_rng(2)
    d = tmp_path / 'in'
    d.mkdir()
    for i, (sr, sec) in enumerate(((48000, 1.2), (48000, 2.6), (48000, 0.4), (44100, 1.0),
                                   (22050, 1.7), (22050, 0.9))):
        write_wav(str(d / ('u%d.wav' % i)),
                  (0.1 * rng.standard_normal(int(sr * sec))).astype(np.float32), sr,
                  dtype='int16')
    return tmp_path


@pytest.mark.parametrize('stages', [2, 3])
def test_extract_features_card_vs_cpu(card, tree, stages):
    """Card against CPU, file for file: f32 within 1e-4, bf16 within one
    bf16 ulp, int8 within one step; K2 launched once per batch."""
    outs = {}
    for dev in ('cpu', 'cuda'):
        for wire in ('f32', 'bf16', 'int8'):
            out = tree / ('%s_%s' % (dev, wire))
            before = lm.fused_log_mel.launches
            stats = Processor.extract_features(str(tree / 'in'), str(out), batch_size=2,
                                               pad_seconds=2.0, wire=wire, stages=stages,
                                               device=dev)
            torch.cuda.synchronize()
            assert stats['utterances'] == 6
            if dev == 'cuda':
                assert lm.fused_log_mel.launches - before == stats['batches'] == 4
                assert len(stats['h2d_ms']) == len(stats['program_ms']) == 4
            outs[dev, wire] = {f: np.load(str(out / f)) for f in sorted(os.listdir(out))}
    for name, ref in outs['cpu', 'f32'].items():
        assert np.abs(outs['cuda', 'f32'][name] - ref).max() <= 1e-4
        bf = outs['cpu', 'bf16'][name]
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(bf), 1e-30))) - 7)
        assert (np.abs(outs['cuda', 'bf16'][name] - bf) <= ulp).all()
        step = (outs['cpu', 'int8'][name].max() - outs['cpu', 'int8'][name].min()) / 254
        assert np.abs(outs['cuda', 'int8'][name] - outs['cpu', 'int8'][name]).max() \
            <= step * 1.001


class Items:
    def __init__(self):
        self.x = np.random.default_rng(0).standard_normal((10, 6)).astype(np.float32)

    def __len__(self):
        return 10

    def __getitem__(self, i):
        start = np.random.randint(0, 3)
        x = self.x[i, start:start + 4]
        return [x, np.float32(x.sum())]


class Regression(Trainer):
    def forward(self, x, y, is_logging=False):
        loss = torch.mean((self.model(x)[..., 0] - y) ** 2)
        return loss, ({'loss': (loss, LogType.SCALAR)} if is_logging else {})


def test_trainer_resume_with_device_prefetch(card, tmp_path):
    """Six steps against three and a resume to six, on the card with the
    default prefetch: the step-6 checkpoints are equal bit for bit."""
    def run(save_dir, max_step):
        np.random.seed(0)
        torch.manual_seed(0)
        model = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 1))
        loaders = [SpeechDataLoader(Items(), batch_size=3, is_shuffle=True) for _ in range(2)]
        Regression(model, torch.optim.Adam(model.parameters(), lr=1e-2), *loaders,
                   max_step=max_step, valid_max_step=2, save_interval=3, log_interval=1,
                   save_dir=str(save_dir), seed=3, device=card).run()
    run(tmp_path / 'a', 6)
    run(tmp_path / 'b', 3)
    run(tmp_path / 'b', 6)
    a, b = (torch.load(tmp_path / d / 'models' / 'save' / 'Sequential' / 'step_000006.chkpt',
                       map_location='cpu', weights_only=True) for d in 'ab')

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        return x == y
    assert same(a, b)
