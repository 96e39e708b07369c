"""Scalar and array helpers: dB <-> log power, mel normalisation, volume
normalisation, 'same' padding. The port's copy of
``pytorch_sound_tpu/utils/calculate.py``: numpy in gives numpy out (float64
where the JAX package computes in float64), a tensor in gives a tensor out."""

from typing import Union

import numpy as np
import torch

from pytorch_sound_tpu_torch import settings

ArrayLike = Union[np.ndarray, torch.Tensor, float, int]


def db2log(db: ArrayLike) -> ArrayLike:
    """Decibels to natural-log power: log(10^(db / 10))."""
    if isinstance(db, torch.Tensor):
        return torch.log(torch.pow(10.0, db / 10.0))
    return np.log(np.power(10.0, np.asarray(db, dtype=np.float64) / 10.0))


def unnorm_mel(x: ArrayLike) -> ArrayLike:
    """Map a [-1, 1]-normalised mel back to the log-mel scale."""
    mel_min, mel_max = db2log(settings.MIN_DB), db2log(settings.MAX_DB)
    return ((x + 1) / 2) * (mel_max - mel_min) + mel_min


def norm_mel(x: ArrayLike) -> ArrayLike:
    """Clamp a log-mel to [MIN_DB, MAX_DB] (log scale) and normalise it to
    [-1, 1]."""
    mel_min, mel_max = db2log(settings.MIN_DB), db2log(settings.MAX_DB)
    if isinstance(x, torch.Tensor):
        x = torch.clamp(x, float(mel_min), float(mel_max))
    else:
        x = np.clip(x, mel_min, mel_max)
    return (x - mel_min) / (mel_max - mel_min) * 2 - 1


def volume_norm_log(x: np.ndarray, target_db: float = settings.VN_DB) -> np.ndarray:
    """RMS volume normalisation (numpy) to the target decibel level."""
    return x / (np.std(x) / 10 ** (target_db / 10))


def volume_norm_log_torch(x: torch.Tensor, target_db: float = settings.VN_DB) -> torch.Tensor:
    """RMS volume normalisation of a tensor to the target decibel level;
    the standard deviation is the population one (numpy's and jnp's
    ``std``, not torch's default unbiased one)."""
    return x / (torch.std(x, correction=0) / 10 ** (target_db / 10))


def conv_same_padding(filter_size: int, stride: int, dilation: int, x: int = 44100) -> int:
    """'same' padding size for a 1d conv with the given geometry."""
    return int(np.ceil(((x / stride - 1) * stride
                        + (filter_size + (filter_size - 1) * (dilation - 1)) - x) / 2))
