"""Tensor helpers: the port's copies of ``pytorch_sound_tpu/utils/tensor.py``'s
``to_numpy`` and ``concat_complex``, and host constants kept on a device."""

import collections

import numpy as np
import torch


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """Copy a tensor to host numpy (waits for the device)."""
    return tensor.detach().cpu().numpy()


def concat_complex(a: torch.Tensor, b: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Concatenate two channel-packed (real||imag) tensors keeping the packing:
    [a_real, b_real, a_imag, b_imag] along ``dim`` (each of a and b split in
    two equal halves there; an odd size raises, as ``jnp.split`` does)."""
    if a.shape[dim] % 2 or b.shape[dim] % 2:
        raise ValueError('concat_complex takes even sizes along dim %d, got %s and %s'
                         % (dim, tuple(a.shape), tuple(b.shape)))
    a_real, a_imag = torch.chunk(a, 2, dim=dim)
    b_real, b_imag = torch.chunk(b, 2, dim=dim)
    return torch.cat([a_real, b_real, a_imag, b_imag], dim=dim)


_CONSTANTS = collections.OrderedDict()    # (id, device, dtype) -> (array, tensor), LRU order
_MAX_CONSTANTS = 64


def device_constant(array: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host numpy constant (one that lives on, such as an ``lru_cache``
    entry) as a tensor of ``like``'s dtype on ``like``'s device, copied there
    once per (array, device, dtype) and reused after. Made outside inference
    mode even when the first caller runs in it, so that a later
    differentiable call can save it for backward. The last 64 are kept,
    least recently used first out, so an array the callers' caches dropped
    is released with its copies in time."""
    key = (id(array), like.device, like.dtype)
    hit = _CONSTANTS.get(key)
    if hit is None or hit[0] is not array:
        with torch.inference_mode(False):
            hit = (array, torch.from_numpy(np.ascontiguousarray(array)).to(
                device=like.device, dtype=like.dtype))
        _CONSTANTS[key] = hit
        while len(_CONSTANTS) > _MAX_CONSTANTS:
            _CONSTANTS.popitem(last=False)
    else:
        _CONSTANTS.move_to_end(key)
    return hit[1]
