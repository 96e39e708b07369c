"""Near-perfect-reconstruction pseudo-QMF analysis and synthesis in plain
PyTorch.

Counterpart of ``pytorch_sound_tpu/ops/pqmf.py``: the Kaiser prototype's
cosine-modulated banks, taps // 2 zeros a side, stride-``subbands`` down- and
zero-stuffed upsampling. The JAX package runs these convolutions through
XLA, not a TPU kernel; here they are ``F.conv1d``.
"""

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch.ops import filters
from pytorch_sound_tpu_torch.utils.tensor import device_constant


@functools.lru_cache(maxsize=8)
def _cached_banks(subbands: int, taps: int, cutoff_ratio: float,
                  beta: float) -> Tuple[np.ndarray, np.ndarray]:
    h_a, h_s = filters.pqmf_banks(subbands, taps, cutoff_ratio, beta)
    return (np.asarray(h_a[:, None, :], dtype=np.float32),     # (S, 1, K)
            np.asarray(h_s[None, :, :], dtype=np.float32))     # (1, S, K)


def analysis(x: torch.Tensor, subbands: int = 4, taps: int = 62,
             cutoff_ratio: float = 0.15, beta: float = 9.0) -> torch.Tensor:
    """(B, 1, T) -> (B, subbands, T // subbands)."""
    bank = device_constant(_cached_banks(subbands, taps, cutoff_ratio, beta)[0], x)
    return F.conv1d(F.pad(x, (taps // 2, taps // 2)), bank)[..., ::subbands]


def synthesis(x: torch.Tensor, subbands: int = 4, taps: int = 62,
              cutoff_ratio: float = 0.15, beta: float = 9.0) -> torch.Tensor:
    """(B, subbands, T // subbands) -> (B, 1, T): each band zero-stuffed by
    ``subbands`` and scaled by it, then the synthesis bank."""
    bank = device_constant(_cached_banks(subbands, taps, cutoff_ratio, beta)[1], x)
    b, s, t = x.shape
    up = F.pad((x * subbands)[..., None], (0, subbands - 1)).reshape(b, s, t * subbands)
    return F.conv1d(F.pad(up, (taps // 2, taps // 2)), bank)
