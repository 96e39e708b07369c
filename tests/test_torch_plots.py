"""The port's plotting helpers (tests/test_misc_utils.py's plot cases) and
the trainer's tensorboard image and plot channels. matplotlib is optional
where the port runs: these cases skip without it, and the trainer reports an
image channel it cannot draw once and goes on."""

import numpy as np
import pytest

from pytorch_sound_tpu_torch import trainer as trainer_mod
from pytorch_sound_tpu_torch.trainer import LogType, Trainer


@pytest.fixture
def plots():
    pytest.importorskip('matplotlib')
    from pytorch_sound_tpu_torch.utils import plots
    return plots


def test_plot_to_buf(plots):
    img = plots.plot_to_buf(np.sin(np.linspace(0, 10, 500)))
    assert img.ndim == 3 and img.shape[0] == 3       # CHW
    assert img.dtype == np.uint8


def test_imshow_to_buf_2d_and_3d(plots):
    x = np.random.default_rng(0).random((80, 100))
    img = plots.imshow_to_buf(x)
    assert img.shape[0] == 3
    img3 = plots.imshow_to_buf(x[None])                    # 3D takes first channel
    assert img3.shape == img.shape


def test_plots_match_jax(plots):
    """The same pixels as the JAX package's helpers."""
    from pytorch_sound_tpu.utils import plots as jax_plots
    x = np.random.default_rng(1).random((40, 60))
    np.testing.assert_array_equal(plots.imshow_to_buf(x), jax_plots.imshow_to_buf(x))
    y = np.cos(np.linspace(0, 5, 300))
    np.testing.assert_array_equal(plots.plot_to_buf(y, align=False),
                                  jax_plots.plot_to_buf(y, align=False))


class _Writer:
    """Records what the trainer hands to a tensorboard writer."""

    def __init__(self):
        self.calls = []

    def add_image(self, name, img, global_step):
        self.calls.append(('image', name, img.shape, global_step))

    def add_scalar(self, name, value, global_step):
        self.calls.append(('scalar', name, value, global_step))


def _bare_trainer():
    t = object.__new__(Trainer)               # tensorboard_log reads these only
    t.writer, t.sr, t._warned_channels = _Writer(), 22050, set()
    return t


def test_trainer_writes_image_and_plot_channels(plots):
    t = _bare_trainer()
    meta = {'mel': (np.random.default_rng(2).random((80, 50)), LogType.IMAGE),
            'curve': (np.sin(np.linspace(0, 3, 100)), LogType.PLOT),
            'loss': (np.float32(0.5), LogType.SCALAR)}
    t.tensorboard_log('train', meta, 7)
    kinds = {name: (kind, step) for kind, name, _, step in t.writer.calls}
    assert kinds == {'train/mel': ('image', 7), 'train/curve': ('image', 7),
                     'train/loss': ('scalar', 7)}
    assert all(c[2][0] == 3 for c in t.writer.calls if c[0] == 'image')


def test_trainer_reports_a_channel_without_matplotlib_once(monkeypatch):
    """Where the helper cannot import, the channel is skipped and reported
    once; the other channels are written."""
    def absent(_):
        raise ImportError('No module named matplotlib')

    monkeypatch.setattr(trainer_mod, 'imshow_to_buf', absent)
    messages = []
    monkeypatch.setattr(trainer_mod, 'log', messages.append)
    t = _bare_trainer()
    for step in (1, 2):
        t.tensorboard_log('train', {'mel': (np.zeros((4, 4)), LogType.IMAGE),
                                    'loss': (np.float32(1.0), LogType.SCALAR)}, step)
    assert [c[:2] for c in t.writer.calls] == [('scalar', 'train/loss')] * 2
    assert len(messages) == 1 and 'train/mel' in messages[0]
