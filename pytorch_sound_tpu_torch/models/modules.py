"""NN building blocks: multi-head self-attention, pointwise FFN, positional
encoding.

Counterpart of ``pytorch_sound_tpu/models/modules.py``, with its parameter
names and its channel-first (N, C, T) interface: post-residual LayerNorm over
channels (flax's eps 1e-6), softmax over the key axis, mask = True for a
padded frame. :func:`load_jax_params` carries a flax parameter tree over.

Long sequences take the blockwise route (:class:`MultiHeadAttention`'s
``block_size`` / ``auto_threshold``), which on a CUDA tensor runs the
flash-attention kernels (``ops/attention.py``).
"""

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_sound_tpu_torch.ops.attention import blockwise_attention

LAYERNORM_EPS = 1e-6     # flax nn.LayerNorm's default


class MultiHeadAttention(nn.Module):
    """Self-attention returning (output (N, C, T), attention weights).

    qkv from a bias-free projection split k, v, q in that order, scaled dot
    product with 1 / sqrt(head_dim), softmax over keys, optional (N, T)
    boolean mask (True = masked out), residual + LayerNorm over channels.

    ``block_size``: 0 (default) is the dense route below ``auto_threshold``
    frames and the blockwise one at or above it; > 0 always blockwise; < 0
    always dense. The dense route returns the map as (N, H, Tk, Tq); the
    blockwise route returns None (the (T, T) map never exists) and zeroes
    masked query rows.
    """

    def __init__(self, hidden_dim: int, heads: int, dropout_rate: float = 0.0,
                 block_size: int = 0, auto_threshold: int = 4096):
        super().__init__()
        self.hidden_dim, self.heads = hidden_dim, heads
        self.block_size, self.auto_threshold = block_size, auto_threshold
        self.linear_kvq = nn.Linear(hidden_dim, 3 * hidden_dim, bias=False)
        self.linear = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.dropout = nn.Dropout(dropout_rate) if 0 < dropout_rate < 1 else None
        self.layernorm = nn.LayerNorm(hidden_dim, eps=LAYERNORM_EPS)

    def uses_blockwise(self, t: int) -> bool:
        return self.block_size > 0 or (self.block_size == 0 and t >= self.auto_threshold)

    def forward(self, input: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        n, c, t = input.shape
        assert c == self.hidden_dim
        head_dim = c // self.heads
        x = input.transpose(1, 2)                                  # (N, T, C)
        k, v, q = (y.reshape(n, t, self.heads, head_dim)           # (N, T, H, D)
                   for y in self.linear_kvq(x).chunk(3, dim=-1))
        if self.uses_blockwise(t):
            out = blockwise_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask=mask,
                block_size=self.block_size if self.block_size > 0 else 512)
            if mask is not None:                                   # out: (N, H, T, D)
                out = out.masked_fill(mask[:, None, :, None], 0.0)
            out = out.transpose(1, 2).reshape(n, t, c)
            att = None
        else:
            att = torch.einsum('nkhd,nqhd->nhkq', k, q) / math.sqrt(head_dim)
            if mask is not None:
                att = att.masked_fill(mask[:, None, :, None], -math.inf)  # keys
            att = torch.softmax(att, dim=2)                        # over keys
            if mask is not None:
                att = att.masked_fill(mask[:, None, None, :], 0.0)  # masked queries
            out = torch.einsum('nkhd,nhkq->nqhd', v, att).reshape(n, t, c)
        out = self.linear(out)
        if self.dropout is not None:
            out = self.dropout(out)
        out = self.layernorm(out + x)                              # add & norm over C
        return out.transpose(1, 2), att


class PointwiseFeedForward(nn.Module):
    """1x1 FFN with 4x expansion, residual + LayerNorm + ReLU; (N, C, T)."""

    def __init__(self, hidden_dim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.ff1 = nn.Linear(hidden_dim, 4 * hidden_dim)
        self.ff2 = nn.Linear(4 * hidden_dim, hidden_dim)
        self.dropout = nn.Dropout(dropout_rate) if 0 < dropout_rate < 1 else None
        self.layernorm = nn.LayerNorm(hidden_dim, eps=LAYERNORM_EPS)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        x = input.transpose(1, 2)                                  # (N, T, C)
        h = self.ff2(F.relu(self.ff1(x)))
        if self.dropout is not None:
            h = self.dropout(h)
        return F.relu(self.layernorm(h + x)).transpose(1, 2)


class PositionalEncoding(nn.Module):
    """Sinusoidal positional encoding added channel-wise on (N, C, T): input
    scaled by sqrt(dim) plus the table."""

    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.dim = dim
        self.register_buffer('pe', self.get_embedding(max_seq_len, dim).T[None].contiguous(),
                             persistent=False)

    @staticmethod
    def get_embedding(num_embeddings: int, embedding_dim: int) -> torch.Tensor:
        inv = 10000 ** (2 * (np.arange(embedding_dim) // 2) / embedding_dim)
        table = np.arange(num_embeddings)[:, None] / inv[None, :]
        table[:, 0::2] = np.sin(table[:, 0::2])
        table[:, 1::2] = np.cos(table[:, 1::2])
        return torch.from_numpy(table.astype(np.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * math.sqrt(self.dim) + self.pe[..., :x.shape[-1]]


def jax_kernel_to_torch(kernel: np.ndarray, transposed: bool = False) -> torch.Tensor:
    """A flax ``kernel`` as the torch ``weight`` of the same layer. Dense
    ``(in, out)`` and Conv ``(*spatial, in, out)`` become ``(out, in,
    *spatial)`` (a Linear's and a ConvNd's layout). A flax ``ConvTranspose``
    correlates the stride-dilated input with its kernel as it stands, where
    torch's ConvTransposeNd correlates it with the kernel flipped in space:
    its kernel becomes ``(in, out, *spatial)`` flipped on every spatial
    axis (``transposed=True``)."""
    arr = torch.from_numpy(np.array(kernel, dtype=np.float32))
    nd = arr.ndim
    spatial = tuple(range(nd - 2))
    if transposed:
        return arr.flip(spatial).permute(nd - 2, nd - 1, *spatial).contiguous()
    return arr.permute(nd - 1, nd - 2, *spatial).contiguous()


def load_jax_params(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Load a flax parameter tree of numpy arrays (with or without the
    top-level 'params' key) into ``module``, whose submodules carry the flax
    names: every ``kernel`` by :func:`jax_kernel_to_torch` (Dense -> Linear,
    Conv -> Conv1d / Conv2d, ConvTranspose -> ConvTranspose1d / 2d, told
    apart by the submodule's type); a LayerNorm or GroupNorm ``scale`` and an
    Embed ``embedding`` (vocab, features) their ``weight`` as they are,
    every ``bias`` itself. Strict: a parameter missing on either side
    raises."""
    state = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + key + '.')
            elif key == 'kernel':
                try:
                    owner = module.get_submodule(prefix[:-1])
                except AttributeError:          # load_state_dict names the stray key
                    owner = None
                state[prefix + 'weight'] = jax_kernel_to_torch(
                    val, isinstance(owner, nn.modules.conv._ConvTransposeNd))
            else:
                arr = torch.from_numpy(np.array(val, dtype=np.float32))
                state[prefix + ('weight' if key in ('scale', 'embedding') else key)] = arr

    walk(tree.get('params', tree), '')
    module.load_state_dict(state)
    return module
