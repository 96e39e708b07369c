"""Ring attention: exact softmax attention over sequence-sharded ranks, the
port's counterpart of ``pytorch_sound_tpu/parallel/ring_attention.py``.

Each rank of the mesh axis holds one contiguous shard of the sequence of Q,
K and V. It computes attention partials (acc, running max, denom) of its
queries against its own K / V shard, then the K / V shards travel round the
ring W - 1 times, each rank sending to rank + 1 and receiving from rank - 1
(``batch_isend_irecv``: JAX's ``lax.ppermute``), and every shard's partials
merge by the associative online-softmax combine
(:func:`~pytorch_sound_tpu_torch.ops.attention.combine_attention_partials`)
in JAX's order. The next exchange is started before the current shard's
partials are computed, so the transfer overlaps them. Local partials are
dense below 2048 rows a shard and blockwise from there on
(:func:`~pytorch_sound_tpu_torch.ops.attention.blockwise_attention_partials`,
O(T_local x block) memory), as in JAX, which computes them with a loop and
not with its flash-attention kernel; so does the port. Forward only: the
exchange records no autograd graph.
"""

import math

import torch
import torch.distributed as dist

from pytorch_sound_tpu_torch.ops.attention import (Partials, blockwise_attention_partials,
                                                   combine_attention_partials)

# per-rank shards at or above this length compute their local partials
# blockwise instead of materializing the (T_local, T_local) score tile
_BLOCKWISE_LOCAL_MIN_T = 2048
LOCAL = ('auto', 'dense', 'blockwise')


def _local_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> Partials:
    """(acc, running_max, denom) of q against one K / V shard (dense scores)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return torch.matmul(p, v), m, p.sum(dim=-1, keepdim=True)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = 'seq', local: str = 'auto') -> torch.Tensor:
    """Exact attention of this rank's queries over the whole sequence, whose
    shards the ranks of ``axis`` of ``mesh`` hold in rank order.

    :param q, k, v: (N, H, T_local, D), this rank's shard of the sequence
    :param local: the per-shard partials: 'dense' materializes the
        (T_local, T_local) score tile, 'blockwise' runs the online-softmax
        scan in O(T_local x block) memory, 'auto' goes blockwise from 2048
        rows a shard
    :return: (N, H, T_local, D), this rank's rows of the output
    """
    if local not in LOCAL:
        raise ValueError('local must be one of %s, got %r' % (LOCAL, local))
    scale = 1.0 / math.sqrt(q.shape[-1])
    if local == 'blockwise' or (local == 'auto' and q.shape[2] >= _BLOCKWISE_LOCAL_MIN_T):
        def partials(k_, v_):
            return blockwise_attention_partials(q, k_, v_, scale=scale)
    else:
        def partials(k_, v_):
            return _local_partials(q, k_, v_, scale)

    group = mesh.get_group(axis)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    send_to = dist.get_global_rank(group, (rank + 1) % world)
    recv_from = dist.get_global_rank(group, (rank - 1) % world)

    def start(kv):
        got = torch.empty_like(kv)
        return got, dist.batch_isend_irecv([dist.P2POp(dist.isend, kv, send_to, group),
                                            dist.P2POp(dist.irecv, got, recv_from, group)])

    if world > 1:
        nxt, reqs = start(torch.stack([k, v]))
    state = partials(k, v)
    for step in range(1, world):
        for req in reqs:
            req.wait()
        kv = nxt
        if step < world - 1:
            nxt, reqs = start(kv)
        state = combine_attention_partials(state, partials(kv[0], kv[1]))
    acc, _, denom = state
    return acc / denom.clamp_min(1e-30)
