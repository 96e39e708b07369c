"""Matplotlib -> CHW uint8 image buffers for the trainer's tensorboard image
and plot channels: the port's copy of ``pytorch_sound_tpu/utils/plots.py``.

matplotlib is imported by the two functions, not by this module: where it is
not installed the package still imports, and only a call raises
``ImportError``.
"""

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _fig_to_chw(plt, fig) -> np.ndarray:
    fig.canvas.draw()
    im = np.asarray(fig.canvas.buffer_rgba())
    plt.clf()
    plt.close('all')
    return np.rollaxis(im[..., :3], 2)


def plot_to_buf(x: np.ndarray, align: bool = True) -> np.ndarray:
    """Line-plot an array into a CHW uint8 image (y limits [-1, 1] if ``align``)."""
    plt = _pyplot()
    x = np.asarray(x)
    fig, ax = plt.subplots()
    ax.plot(x)
    if align:
        ax.set_ylim([-1, 1])
    return _fig_to_chw(plt, fig)


def imshow_to_buf(x: np.ndarray) -> np.ndarray:
    """Render a 2d array (or first channel of a 3d one) into a CHW uint8 image."""
    plt = _pyplot()
    x = np.asarray(x)
    if x.ndim == 3:
        x = x[0]
    fig, ax = plt.subplots()
    ax.imshow(x, aspect='auto')
    return _fig_to_chw(plt, fig)
