"""Griffin-Lim phase reconstruction: |STFT| -> waveform.

Counterpart of ``pytorch_sound_tpu/ops/griffin_lim.py``: alternate iSTFT /
STFT projections (the port's :func:`~pytorch_sound_tpu_torch.ops.stft.stft`
and ``istft``, cuFFT on a CUDA tensor) while keeping the target magnitude,
with the fast-Griffin-Lim momentum, a fixed iteration count, on the
magnitude's device. The JAX function draws its random initial phase from a
PRNGKey; here it is drawn from a ``torch.Generator``, so only the zero phase
(``rng=None``) reproduces the JAX output.
"""

import math
from typing import Optional

import torch

from pytorch_sound_tpu_torch.ops import stft as stft_ops


def griffin_lim(magnitude: torch.Tensor, n_fft: int, hop_length: int,
                win_length: Optional[int] = None, n_iter: int = 32,
                momentum: float = 0.99, length: Optional[int] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Reconstruct (..., samples) audio from |STFT| (..., F, T).

    :param momentum: fast-GLA momentum in [0, 1) (0 = classic Griffin-Lim)
    :param rng: a ``torch.Generator`` that draws the initial phase, uniform
        in [-pi, pi), on its own device (zero phase when None)
    """
    win_length = win_length or n_fft

    if rng is not None:
        phase = torch.rand(magnitude.shape, generator=rng, device=rng.device,
                           dtype=magnitude.dtype)
        phase = (phase * (2 * math.pi) - math.pi).to(magnitude.device)
        real, imag = magnitude * torch.cos(phase), magnitude * torch.sin(phase)
    else:
        real, imag = magnitude, torch.zeros_like(magnitude)

    def project(re, im):
        """iSTFT -> STFT round trip (projection onto consistent spectrograms)."""
        wav = stft_ops.istft(re, im, n_fft, hop_length, win_length)
        re2, im2 = stft_ops.stft(wav, n_fft, hop_length, win_length)
        t = min(re.shape[-1], re2.shape[-1])
        return re2[..., :t], im2[..., :t]

    def impose(re, im):
        """The target magnitude on the new phase."""
        t = re.shape[-1]
        scale = magnitude[..., :t] / (torch.sqrt(re ** 2 + im ** 2) + 1e-12)
        return scale * re, scale * im

    re, im = impose(*project(real, imag))
    prev_re, prev_im = re, im
    for _ in range(n_iter):
        # momentum extrapolation (fast Griffin-Lim)
        acc_re = re + momentum * (re - prev_re)
        acc_im = im + momentum * (im - prev_im)
        new_re, new_im = impose(*project(acc_re, acc_im))
        t = new_re.shape[-1]
        prev_re, prev_im = re[..., :t], im[..., :t]
        re, im = new_re, new_im
    return stft_ops.istft(re, im, n_fft, hop_length, win_length, length=length)
