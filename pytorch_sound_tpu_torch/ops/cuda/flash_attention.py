"""Flash attention: wrappers of the CUDA kernels ``csrc/flash_attention.cu`` (K5).

Counterpart of ``pytorch_sound_tpu/ops/pallas/flash_attention.py`` in its
layout: q (N, H, Tq, D), k and v (N, H, Tk, D), a key mask over (N, Tk).

- :func:`flash_attention` (K5a): the forward; ``mask`` True = key masked out.
- :func:`flash_attention_trainable` (K5b): the same output as an autograd
  function whose backward is the dK / dV and dQ kernels (JAX
  ``_flash_bwd_rule``); ``key_valid`` 1 = attend, and it gets no gradient.

Three entry points, each with a launch counter: :func:`attention_forward`
(o and the row logsumexp), :func:`attention_dkv` and :func:`attention_dq`.
Each dispatches on the tensor's device: on the CPU it runs its plain version
(:func:`attention_reference`, :func:`attention_dkv_reference`,
:func:`attention_dq_reference`, dense
fp32 with the same ``-1e30`` masking), on a CUDA tensor it launches its kernel
or raises. On the CPU :func:`flash_attention_trainable` is autograd through
the plain forward.

The kernels take every head width D <= 256, pick their own tiles and give
fp32 results (on the tensor cores as 3xTF32), so JAX's tile, interpret and
precision arguments have no counterpart here. All three kernels skip a key
tile whose keys are all masked when its item has a valid key (there p = 0
exactly, and the forward's result is bit for bit the same);
:func:`live_key_tiles` reckons which tiles they process, at the tile sizes
:func:`forward_key_tile` and :func:`backward_key_tiles` give.

A query row whose keys are all masked gets the mean of v over its Tk keys
(softmax of a row of equal -1e30 scores). JAX's padded kernel averages over
its padded key count instead, so such rows are not held to JAX; their
gradients are those of the kernels' recomputed ``p = exp(s - lse)``.
"""

import math
from typing import Optional, Tuple

import torch

from pytorch_sound_tpu_torch.ops.cuda import _build

SOURCE = 'pytorch_sound_tpu_torch/csrc/flash_attention.cu'
NEG_INF = -1e30
MAX_HEAD_DIM = 256


def _scores(q: torch.Tensor, k: torch.Tensor, key_valid: Optional[torch.Tensor]):
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if key_valid is not None:
        s = torch.where(key_valid[:, None, None, :] > 0.5, s, NEG_INF)
    return s


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (o (N, H, Tq, D), lse (N, H, Tq)), dense, with the
    kernel's -1e30 masking and 1e-30 denominator floor. Differentiable in o."""
    s = _scores(q, k, key_valid)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(p, v) / denom, (m + torch.log(denom))[..., 0]


def _probs_and_ds(q, k, v, key_valid, dout, lse, di):
    """p = exp(s - lse) and ds = p (do v^T - di) / sqrt(D), as the backward
    kernels recompute them from the residuals."""
    p = torch.exp(_scores(q, k, key_valid) - lse[..., None])
    dp = torch.matmul(dout, v.transpose(-1, -2))
    return p, p * (dp - di[..., None]) * (1.0 / math.sqrt(q.shape[-1]))


def attention_dkv_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            key_valid: Optional[torch.Tensor], dout: torch.Tensor,
                            lse: torch.Tensor, di: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dK / dV from the residuals: (ds^T q, p^T do), dense."""
    p, ds = _probs_and_ds(q, k, v, key_valid, dout, lse, di)
    return torch.matmul(ds.transpose(-1, -2), q), torch.matmul(p.transpose(-1, -2), dout)


def attention_dq_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_valid: Optional[torch.Tensor], dout: torch.Tensor,
                           lse: torch.Tensor, di: torch.Tensor) -> torch.Tensor:
    """Plain dQ from the residuals: ds k, dense."""
    return torch.matmul(_probs_and_ds(q, k, v, key_valid, dout, lse, di)[1], k)


def _padded(d: int) -> int:
    return next(p for p in (16, 32, 64, 128, 192, 256) if d <= p)


def forward_key_tile(d: int) -> int:
    """Keys per step of the forward kernel at head width ``d`` (its
    ``BwdTile<DP, dq_split(DP), kFwdWarps>::BN``)."""
    return 32 if _padded(d) > 64 else 64


def backward_key_tiles(d: int) -> Tuple[int, int]:
    """Keys per tile of the dK / dV kernel (the keys a block owns) and of the
    dQ kernel (the keys it walks per step) at head width ``d``, as the
    kernels' ``BwdTile`` picks them from the padded width."""
    dp = _padded(d)
    return 64 // (1 if dp <= 64 else 2 if dp <= 128 else 4), 32 if dp > 64 else 64


def live_key_tiles(key_valid: torch.Tensor, tile: int) -> torch.Tensor:
    """(N, ceil(Tk / tile)) bool: the ``tile``-key tiles of ``key_valid``
    (N, Tk) that the kernels process. A tile is skipped when none of
    its keys is valid (key_valid >= 0.5) and its item has a valid key; an
    item with no valid key keeps every tile, since there each masked key has
    p = 1."""
    n, tk = key_valid.shape
    tiles = -(-tk // tile)
    valid = torch.zeros((n, tiles * tile), dtype=torch.bool, device=key_valid.device)
    valid[:, :tk] = ~(key_valid < 0.5)
    live = valid.view(n, tiles, tile).any(dim=2)
    return live | ~live.any(dim=1, keepdim=True)


def _on_card(name: str, *tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raise on any other device or
    on a mix."""
    dev = tensors[0].device
    if dev.type not in ('cpu', 'cuda'):
        raise RuntimeError('%s runs on cpu or cuda, not %s' % (name, dev))
    for t in tensors:
        if t is not None and t.device != dev:
            raise RuntimeError('%s: tensors on %s and %s' % (name, dev, t.device))
    return dev.type == 'cuda'


def _check(name: str, q, k, v, key_valid, *rest):
    """Shapes and types the kernels take: contiguous float32 q (N, H, Tq, D),
    k / v (N, H, Tk, D), D <= 256, key_valid (N, Tk) or None, and the
    cotangent / residuals in ``rest``."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or \
            q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError('%s: q (N, H, Tq, D) and k, v (N, H, Tk, D), got %s %s %s'
                         % (name, tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    n, _, tq, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM or tq < 1 or k.shape[2] < 1:
        raise ValueError('%s: the kernels take 1 <= D <= %d and nonempty sequences, got %s %s'
                         % (name, MAX_HEAD_DIM, tuple(q.shape), tuple(k.shape)))
    if key_valid is not None and key_valid.shape != (n, k.shape[2]):
        raise ValueError('%s: key_valid must be (N, Tk) = %s, got %s'
                         % (name, (n, k.shape[2]), tuple(key_valid.shape)))
    for t in (q, k, v, key_valid, *rest):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError('%s kernel takes contiguous float32 tensors, got %s %s'
                             % (name, t.dtype, tuple(t.shape)))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dims(q: torch.Tensor, k: torch.Tensor):
    """(bh, heads, tq, tk, d, scale) of the C entry points."""
    n, h, tq, d = q.shape
    return n * h, h, tq, k.shape[2], d, 1.0 / math.sqrt(d)


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_valid: Optional[torch.Tensor] = None, with_lse: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(o (N, H, Tq, D), lse (N, H, Tq) or None without ``with_lse``). The
    forward kernel on CUDA tensors, :func:`attention_reference` on CPU ones.
    ``key_valid`` (N, Tk) float32, 1 = attend."""
    if not _on_card('attention_forward', q, k, v, key_valid):
        o, lse = attention_reference(q, k, v, key_valid)
        return o, lse if with_lse else None
    _check('attention_forward', q, k, v, key_valid)
    o = torch.empty_like(q)
    lse = q.new_empty(q.shape[:3]) if with_lse else None
    with torch.cuda.device(q.device):
        code = _build.library().flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_valid), o.data_ptr(),
            _ptr(lse), *_dims(q, k), torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'flash_attention_forward')
    attention_forward.launches += 1
    return o, lse


attention_forward.launches = 0


def attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_valid: Optional[torch.Tensor], dout: torch.Tensor, lse: torch.Tensor,
                  di: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) (N, H, Tk, D) from the cotangent ``dout`` (N, H, Tq, D), the
    forward's ``lse`` and ``di = rowsum(o * dout)`` (N, H, Tq)."""
    if not _on_card('attention_dkv', q, k, v, key_valid, dout, lse, di):
        return attention_dkv_reference(q, k, v, key_valid, dout, lse, di)
    _check('attention_dkv', q, k, v, key_valid, dout, lse, di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = _build.library().flash_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_valid), dout.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_dims(q, k),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'flash_attention_dkv')
    attention_dkv.launches += 1
    return dk, dv


attention_dkv.launches = 0


def attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_valid: Optional[torch.Tensor], dout: torch.Tensor, lse: torch.Tensor,
                 di: torch.Tensor) -> torch.Tensor:
    """dq (N, H, Tq, D) from the same inputs as :func:`attention_dkv`."""
    if not _on_card('attention_dq', q, k, v, key_valid, dout, lse, di):
        return attention_dq_reference(q, k, v, key_valid, dout, lse, di)
    _check('attention_dq', q, k, v, key_valid, dout, lse, di)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _build.library().flash_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_valid), dout.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), *_dims(q, k),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, 'flash_attention_dq')
    attention_dq.launches += 1
    return dq


attention_dq.launches = 0


def _key_valid(key_valid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if key_valid is None else key_valid.to(torch.float32).contiguous()


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, key_valid):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = attention_forward(q, k, v, key_valid)
        ctx.save_for_backward(q, k, v, key_valid, o, lse)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        di = (o * dout).sum(dim=-1)
        dk, dv = attention_dkv(q, k, v, key_valid, dout, lse, di)
        dq = attention_dq(q, k, v, key_valid, dout, lse, di)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention (N, H, Tq, D) x (N, H, Tk, D) -> (N, H, Tq, D);
    ``mask`` (N, Tk) boolean, True = key masked out. K5a: the forward kernel
    without the logsumexp on a CUDA tensor, the plain version on a CPU one."""
    key_valid = None if mask is None else (~mask.bool()).to(torch.float32).contiguous()
    return attention_forward(q.contiguous(), k.contiguous(), v.contiguous(), key_valid,
                             with_lse=False)[0]


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable flash attention (K5b): ``key_valid`` (N, Tk), 1 =
    attend, None = all. On CUDA tensors the forward kernel, and in the
    backward the dK / dV and dQ kernels; on CPU tensors autograd through
    the plain forward. Same output as :func:`flash_attention`."""
    key_valid = _key_valid(key_valid)
    if not _on_card('flash_attention_trainable', q, k, v, key_valid):
        return attention_reference(q, k, v, key_valid)[0]
    return _FlashAttention.apply(q, k, v, key_valid)
