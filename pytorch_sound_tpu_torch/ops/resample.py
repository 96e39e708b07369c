"""Rational resampling (Kaiser polyphase) and per-row RMS normalisation on
tensors: the port's copy of ``pytorch_sound_tpu/ops/resample.py``.

The filter is the native resampler's (``csrc/tpusound.cc`` ``ts_resample``:
a Kaiser(beta=8.6) windowed-sinc prototype, 24 taps per phase). After the
ratio is reduced to coprime up / down, super-block q (``up`` consecutive
outputs) depends only on the input window [q*down - half, q*down + down +
half), so one fixed matrix

    M[r, floor(r*down/up) + j] = bank[(r*down) % up][j]      j < taps

turns the resample into one (B*Q, down+taps) x (down+taps, up) product over
windows taken as strided views of the padded signal (``unfold``). The JAX
package pins that product to fp32 (``Precision.HIGHEST``). Here it runs in
float64 and the result is rounded to the input's dtype: the native loop's
arithmetic (float taps, a double accumulator), and no TF32 setting
(``torch.backends.cuda.matmul.allow_tf32``, ``set_float32_matmul_precision``)
can reach it. The product is a plain matrix product outside any TPU kernel,
left to cuBLAS on the card.
"""

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch.utils.tensor import device_constant

TAPS_PER_PHASE = 24
KAISER_BETA = 8.6


def _bessel_i0(x: np.ndarray) -> np.ndarray:
    """Power-series modified Bessel I0 (as ``csrc/tpusound.cc``)."""
    x = np.asarray(x, np.float64)
    total = np.ones_like(x)
    term = np.ones_like(x)
    for k in range(1, 64):
        term = term * (x / (2.0 * k)) ** 2
        total = total + term
        if np.all(term < 1e-16 * total):
            break
    return total


@functools.lru_cache(maxsize=32)
def kaiser_polyphase_bank(up: int, down: int, taps_per_phase: int = TAPS_PER_PHASE,
                          beta: float = KAISER_BETA) -> np.ndarray:
    """(up, taps_per_phase) float32 polyphase bank, the native resampler's:
    bank[r][j] = up * sinc_lp(r + (half_src - j) * up) * kaiser(beta)."""
    half = (taps_per_phase // 2) * up
    h_src = taps_per_phase // 2
    cutoff = 1.0 / max(up, down)
    r = np.arange(up)[:, None].astype(np.float64)
    j = np.arange(taps_per_phase)[None, :].astype(np.float64)
    t = r + (h_src - j) * up
    sinc = np.where(t == 0.0, cutoff, np.sin(np.pi * cutoff * t)
                    / np.where(t == 0.0, 1.0, np.pi * t))
    frac = t / (half + 1.0)
    w = _bessel_i0(beta * np.sqrt(np.maximum(0.0, 1.0 - frac * frac)))
    w = w / _bessel_i0(np.asarray(beta))
    return (sinc * w * up).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _block_matrix(up: int, down: int, taps_per_phase: int = TAPS_PER_PHASE,
                  beta: float = KAISER_BETA) -> np.ndarray:
    """(W, up) float32 matrix, W = down + taps: window q of the padded input
    (starting at q*down) times it gives outputs q*up .. q*up + up - 1."""
    bank = kaiser_polyphase_bank(up, down, taps_per_phase, beta)
    m = np.zeros((down + taps_per_phase, up), np.float32)
    for r in range(up):
        off = (r * down) // up            # floor; phase = (r*down) % up
        m[off:off + taps_per_phase, r] = bank[(r * down) % up]
    return m


def resample_out_len(n_in: int, orig_sr: int, target_sr: int) -> int:
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    return -(-n_in * up // down)


def resample_poly(x: torch.Tensor, orig_sr: int, target_sr: int,
                  taps_per_phase: int = TAPS_PER_PHASE,
                  beta: float = KAISER_BETA) -> torch.Tensor:
    """Rational resample of (..., T) from ``orig_sr`` to ``target_sr``, on
    ``x``'s device, in ``x``'s floating dtype: within 2e-6 of the native
    ``ts_resample`` (the tests hold it there and to the JAX function)."""
    if orig_sr == target_sr:
        return x
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g

    batch_shape = x.shape[:-1]
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    n_q = -(-n_out // up)                 # super-blocks of `up` outputs
    h_src = taps_per_phase // 2
    w_len = down + taps_per_phase
    # window q is padded[q*down : q*down + w_len]; pad the back so the last
    # window is whole (JAX's shifted-reshape views need the same length)
    max_s = ((w_len - 1) // down) * down
    pad_back = max(0, max_s + n_q * down - (h_src + n_in))
    xp = F.pad(x.reshape(-1, n_in).to(torch.float64), (h_src, pad_back))
    windows = xp.unfold(-1, w_len, down)[:, :n_q]          # (B, n_q, w_len) view
    m = device_constant(_block_matrix(up, down, taps_per_phase, beta), xp)
    y = torch.matmul(windows, m)                           # (B, n_q, up), fp64
    return y.reshape(-1, n_q * up)[:, :n_out].to(x.dtype).reshape(*batch_shape, n_out)


def rms_normalize(x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                  target_db: float = -23.0, eps: float = 1e-12) -> torch.Tensor:
    """Per-row RMS normalisation to ``target_db`` dBFS (the native
    ``ts_rms_normalize``'s gain). ``lengths`` masks zero padding: padded
    zeros add nothing to the sum, so only the divisor takes the true length."""
    n = x.shape[-1] if lengths is None else lengths
    sq = torch.sum(x * x, dim=-1)
    rms = torch.sqrt(sq / torch.clamp(torch.as_tensor(n, dtype=x.dtype, device=x.device),
                                      min=1.0))
    gain = (10.0 ** (target_db / 20.0)) / torch.clamp(rms, min=eps)
    return x * gain[..., None]
