"""Tensor helper, the port's copy of ``pytorch_sound_tpu/utils/tensor.py``'s
``to_numpy``."""

import numpy as np
import torch


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """Copy a tensor to host numpy (waits for the device)."""
    return tensor.detach().cpu().numpy()
