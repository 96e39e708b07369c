"""Small iteration helpers: the port's copy of
``pytorch_sound_tpu/utils/iterer.py``."""

from collections.abc import Iterable


def _ntuple(n: int):
    def parse(x):
        if isinstance(x, Iterable) and not isinstance(x, str):
            return x
        return tuple([x] * n)
    return parse


def repeat(iterable):
    """Loop over an iterable forever (re-iterating each epoch)."""
    while True:
        for x in iterable:
            yield x


single = _ntuple(1)
double = _ntuple(2)
