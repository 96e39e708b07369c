"""Blockwise (flash-style) attention that never materializes the (T, T) map.

Counterpart of ``pytorch_sound_tpu/ops/attention.py``. Backends of
:func:`blockwise_attention`, by the JAX package's names:

- ``'cuda'`` (JAX ``'pallas'``): the flash-attention kernels
  (``ops/cuda/flash_attention.py::flash_attention_trainable``, K5b): the
  forward kernel, and under a gradient the dK / dV and dQ kernels. On a CPU
  tensor that function runs its plain version (dense).
- ``'scan'`` (JAX ``'lax'``): the online-softmax loop over key blocks in
  plain torch, peak memory O(Tq x block).
- ``'auto'``: ``'cuda'`` on a CUDA tensor, ``'scan'`` on a CPU one, as JAX
  picks ``'pallas'`` on a TPU and ``'lax'`` elsewhere.

Both run in fp32: JAX's precision and tile-autotuning arguments have no
counterpart. An item whose keys are all masked gets the mean of v over its
Tk keys on every backend (masked keys score -1e30, the scan's block padding
-inf). The per-shard (acc, max, denom) partials combine associatively
(:func:`combine_attention_partials`), the ring-attention reduction.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
BACKENDS = ('auto', 'cuda', 'scan')

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, block_size: int = 256,
                        backend: str = 'auto') -> torch.Tensor:
    """Softmax attention over key blocks with online renormalization.

    :param q: queries (N, H, Tq, D)
    :param k: keys    (N, H, Tk, D)
    :param v: values  (N, H, Tk, D)
    :param mask: optional (N, Tk) boolean, True = key masked out
    :param block_size: key-block length of the scan (keys padded to a
        multiple); the kernel picks its own tiles and ignores it
    :param backend: 'cuda', 'scan' or 'auto' (see the module docstring)
    :return: (N, H, Tq, D)
    """
    if backend not in BACKENDS:
        raise ValueError('backend must be one of %s, got %r' % (BACKENDS, backend))
    if backend == 'auto':
        backend = 'cuda' if q.device.type == 'cuda' else 'scan'
    if backend == 'cuda':
        from pytorch_sound_tpu_torch.ops.cuda.flash_attention import flash_attention_trainable
        key_valid = None if mask is None else (~mask.bool()).to(torch.float32)
        return flash_attention_trainable(q, k, v, key_valid)
    acc, _, denom = _scan_partials(q, k, v, mask, block_size, 1.0 / math.sqrt(q.shape[-1]))
    return acc / denom.clamp_min(1e-30)


def _scan_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], block_size: int, scale: float) -> Partials:
    """(acc, m, denom) online-softmax partials of q against key blocks.

    The keys are padded to a block multiple; the keys ``mask`` (N, Tk) marks
    True score -1e30, as in the kernels, and the padding -inf, so it weighs
    nothing even in a row whose keys are all masked. Peak memory is
    O(Tq x block_size)."""
    n, h, tq, d = q.shape
    tk = k.shape[2]
    pad = (-tk) % block_size
    if pad:
        k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    is_key = torch.arange(tk + pad, device=q.device) < tk
    key_valid = is_key[None, :].expand(n, tk + pad)
    if mask is not None:
        key_valid = key_valid & ~F.pad(mask.bool(), (0, pad), value=True)
    fill = torch.where(is_key, NEG_INF, -math.inf).to(q.dtype)       # (Tk + pad,)
    acc = q.new_zeros((n, h, tq, d))
    m = q.new_full((n, h, tq, 1), NEG_INF)
    denom = q.new_zeros((n, h, tq, 1))
    for start in range(0, k.shape[2], block_size):
        kb = k[:, :, start:start + block_size]
        vb = v[:, :, start:start + block_size]
        s = torch.matmul(q, kb.transpose(-1, -2)) * scale
        s = torch.where(key_valid[:, None, None, start:start + block_size], s,
                        fill[start:start + block_size])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        acc = acc * alpha + torch.matmul(p, vb)
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
    return acc, m, denom


def blockwise_attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                 block_size: int = 512,
                                 scale: Optional[float] = None) -> Partials:
    """(acc, m, denom) partials of q against this k / v shard in O(Tq x block)
    memory: the ring-attention local step, without the (Tq, Tk) score map."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _scan_partials(q, k, v, None, block_size, scale)


def combine_attention_partials(a: Partials, b: Partials) -> Partials:
    """Associatively merge two (acc, max, denom) attention partials: the
    cross-device reduction of sequence-sharded (ring) attention."""
    acc_a, m_a, d_a = a
    acc_b, m_b, d_b = b
    m = torch.maximum(m_a, m_b)
    wa = torch.exp(m_a - m)
    wb = torch.exp(m_b - m)
    return acc_a * wa + acc_b * wb, m, d_a * wa + d_b * wb
