"""Wave-level ops in plain PyTorch: the pre-emphasis pair, the windowed
volume norm, spectrogram masking, the multi-resolution STFT loss and mu-law.

Counterpart of ``pytorch_sound_tpu/ops/sound.py``, with its semantics. None of
it reaches a TPU kernel in the JAX package. The inverse pre-emphasis, an IIR
the JAX package computes as an associative scan, is a blocked scan here
(:func:`inv_preemphasis`).
"""

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_sound_tpu_torch.ops import stft as stft_ops
from pytorch_sound_tpu_torch.utils.tensor import device_constant

SCAN_BLOCK = 256          # samples per block of the inverse pre-emphasis scan


def preemphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[t] = x[t] - coef * x[t-1] on (..., T), the first sample's
    predecessor reflected (x[1]), so lengths match."""
    prev = torch.cat([x[..., 1:2], x[..., :-1]], dim=-1)
    return x - coef * prev


@functools.lru_cache(maxsize=16)
def _power_matrix(coef: float, n: int) -> np.ndarray:
    """(n, n) float64 lower-triangular ``coef ** (i - j)`` for i >= j, zero
    above: the block's response to its own inputs."""
    d = np.arange(n)[:, None] - np.arange(n)[None, :]
    with np.errstate(over='ignore', under='ignore'):
        return np.where(d >= 0, float(coef) ** np.maximum(d, 0), 0.0)


@functools.lru_cache(maxsize=16)
def _carry_gain(coef: float, n: int) -> np.ndarray:
    """(n,) float64 ``coef ** (i + 1)``: a block's response to the carry."""
    return float(coef) ** np.arange(1, n + 1)


def _linear_scan(x: torch.Tensor, coef: float) -> torch.Tensor:
    """y[t] = x[t] + coef * y[t-1] (y[-1] = 0) along the last axis of
    (R, T): per block of SCAN_BLOCK samples the power-matrix product from
    a zero state, then the carries, which are the same recurrence over the
    blocks' last values at ``coef ** SCAN_BLOCK``, by recursion."""
    r, t = x.shape
    b = min(SCAN_BLOCK, t)
    n_blocks = -(-t // b)
    xb = F.pad(x, (0, n_blocks * b - t)).reshape(r, n_blocks, b)
    local = torch.matmul(xb, device_constant(_power_matrix(coef, b), x).T)
    if n_blocks > 1:
        # y at each block's end; the carry into block j is that of block j - 1
        ends = _linear_scan(local[..., -1], coef ** b)
        gain = device_constant(_carry_gain(coef, b), x)
        local = torch.cat([local[:, :1], local[:, 1:] + ends[:, :-1, None] * gain], dim=1)
    return local.reshape(r, n_blocks * b)[:, :t]


def inv_preemphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """Inverse IIR of :func:`preemphasis` from a zero state:
    y[t] = x[t] + coef * y[t-1], on (..., T).

    A closed form through ``coef ** -t`` overflows at realistic T, and a
    loop over samples is T sequential steps. So the scan runs in blocks of
    SCAN_BLOCK samples: each block is one product with a lower-triangular
    power matrix (every power <= 1 for |coef| <= 1), and the carries across
    blocks are the same recurrence over the blocks' ends at
    ``coef ** SCAN_BLOCK``, so the sequential depth is log_256 T products.
    Computed in float64 and cast back, so its rounding is below the
    input dtype's.
    """
    lead, t = x.shape[:-1], x.shape[-1]
    if t == 0:
        return x
    y = _linear_scan(x.reshape(-1, t).to(torch.float64), coef)
    return y.to(x.dtype).reshape(*lead, t)


def windowed_volume_stats(wav: torch.Tensor, window_size: int, hop_size: int) -> torch.Tensor:
    """Unbiased std of wav[h : h + window] for each hop start h in
    range(0, T - window, hop), the last window cut at the signal's end:
    (..., n_hops), from cumulative sums."""
    t = wav.shape[-1]
    starts = list(range(0, t - window_size, hop_size))
    csum = F.pad(torch.cumsum(wav, dim=-1), (1, 0))
    csum2 = F.pad(torch.cumsum(wav * wav, dim=-1), (1, 0))
    idx_s = torch.tensor(starts, dtype=torch.long, device=wav.device)
    idx_e = torch.clamp(idx_s + window_size, max=t)
    n = (idx_e - idx_s).to(wav.dtype)
    s1 = csum[..., idx_e] - csum[..., idx_s]
    s2 = csum2[..., idx_e] - csum2[..., idx_s]
    var = (s2 - s1 * s1 / n) / torch.clamp(n - 1, min=1)   # unbiased, as torch.std
    return torch.sqrt(torch.clamp(var, min=0.0))


def _per_sample_gain(stds: torch.Tensor, hop_size: int, target_db: float,
                     out_len: int) -> torch.Tensor:
    gain = stds / (10 ** (target_db / 10))
    chunk = torch.clamp(torch.arange(out_len, device=stds.device) // hop_size,
                        max=stds.shape[-1] - 1)
    return gain[..., chunk]


def windowed_volume_norm(wav: torch.Tensor, window_size: int, hop_size: int,
                         target_db: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hop-wise volume normalization (VolNormConv.forward): each hop chunk
    divided by (its window's std / 10^(db / 10)), the last chunk taking the
    tail where its window reaches the signal's end. Returns (normalized wav,
    per-hop stds for the reverse)."""
    t = wav.shape[-1]
    stds = windowed_volume_stats(wav, window_size, hop_size)
    n_hops = stds.shape[-1]
    last_hop = (n_hops - 1) * hop_size
    out_len = t if last_hop >= t - window_size - 1 else n_hops * hop_size
    gain = _per_sample_gain(stds, hop_size, target_db, out_len)
    return wav[..., :out_len] / torch.clamp(gain, min=1e-12), stds


def windowed_volume_reverse(wav: torch.Tensor, stds: torch.Tensor, window_size: int,
                            hop_size: int, target_db: float) -> torch.Tensor:
    """Undo :func:`windowed_volume_norm` with its per-hop stds."""
    return wav * _per_sample_gain(stds, hop_size, target_db, wav.shape[-1])


def spectrogram_mask(wav_mask: torch.Tensor, win_length: int, hop_length: int) -> torch.Tensor:
    """Wave-level {0, 1} mask -> frame-level mask (SpectrogramMasker): win // 2
    zeros on the right, win // 2 ones on the left, the windowed mean, ceil."""
    m = F.pad(wav_mask.to(torch.float32), (0, win_length // 2))
    m = F.pad(m, (win_length // 2, 0), value=1.0)
    return torch.ceil(stft_ops.frame(m, win_length, hop_length).mean(dim=-1))


def _loss_magnitude(x: torch.Tensor, n_fft: int, win: int, hop: int) -> torch.Tensor:
    return stft_ops.spectrogram_magnitude(x, n_fft, hop, win, center=True,
                                          pad_mode='reflect')


def multi_stft_loss(pred: torch.Tensor, target: torch.Tensor,
                    stft_params: List[Tuple[int, int, int]], eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-resolution STFT loss over (n_fft, win, hop) triples: (total,
    spectral convergence, log magnitude), each the mean over resolutions;
    total = sc + mag per resolution."""
    loss = sc_loss = mag_loss = 0.0
    for n_fft, win, hop in stft_params:
        p_mag = _loss_magnitude(pred, n_fft, win, hop)
        t_mag = _loss_magnitude(target, n_fft, win, hop)
        axes = (-2, -1)
        fro = torch.sqrt(torch.sum((t_mag - p_mag) ** 2, dim=axes))
        t_fro = torch.sqrt(torch.sum(t_mag ** 2, dim=axes))
        sc = torch.mean(fro / torch.clamp(t_fro, min=1e-12))
        n = t_mag.shape[-1] * t_mag.shape[-2]
        mag = torch.mean(torch.sum(torch.abs(torch.log(t_mag + eps) - torch.log(p_mag + eps)),
                                   dim=axes)) / n
        loss = loss + sc + mag
        sc_loss = sc_loss + sc
        mag_loss = mag_loss + mag
    k = len(stft_params)
    return loss / k, sc_loss / k, mag_loss / k


def mulaw_encode(x: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """mu-law compand and quantize to ``bins`` levels (int32)."""
    mu = bins - 1.0
    x = torch.clamp(x, -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / np.log1p(mu)
    return torch.round((y + 1.0) / 2.0 * mu).to(torch.int32)


def mulaw_decode(q: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Inverse of :func:`mulaw_encode` (float32)."""
    mu = bins - 1.0
    y = 2.0 * q.to(torch.float32) / mu - 1.0
    return torch.sign(y) * (torch.pow(1.0 + mu, torch.abs(y)) - 1.0) / mu
