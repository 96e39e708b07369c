"""Transformer-TTS acoustic model: text -> mel spectrogram.

Counterpart of ``pytorch_sound_tpu/models/tts.py``: a text encoder and an
autoregressive mel decoder with causal self-attention and cross-attention,
trained teacher-forced with masked L1 mel + stop-token losses
(``examples/ljspeech_tts.py``); :func:`synthesize` is the greedy KV-cached
inference. Submodules carry the flax names (``enc_attn_0``, ``dec_ln_5``,
``Dense_0`` ...), so :func:`~pytorch_sound_tpu_torch.models.modules.load_jax_params`
carries a JAX parameter tree over.

Attention is the JAX module's plain product: a scaled ``einsum``, masked
scores set to ``NEG`` = -1e30, softmax over the keys, ``einsum`` with the
values. The JAX package runs it outside any Pallas kernel, and so does the
port (neither the flash-attention kernels nor SDPA). Layout: (N, C, T) at
the API boundary, (N, T, C) inside. LayerNorm takes flax's eps 1e-6 and GELU
its tanh form.
"""

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_sound_tpu_torch.models import register_model, register_model_architecture
from pytorch_sound_tpu_torch.models.modules import LAYERNORM_EPS, PositionalEncoding
from pytorch_sound_tpu_torch.ops.mel import db_to_log

NEG = -1e30
STOP_CHECK_FRAMES = 16      # synthesize's host sync on the stop flags, every this many frames


class _Attention(nn.Module):
    """Multi-head attention on (N, T, C) with causal / key masking.

    Besides the full (teacher-forced) forward, the two pieces incremental
    decoding needs: :meth:`kv` (project keys / values once) and
    :meth:`attend_step` (one query frame against cached K / V).
    """

    def __init__(self, hidden_dim: int, heads: int, causal: bool = False):
        super().__init__()
        self.hidden_dim, self.heads, self.causal = hidden_dim, heads, causal
        self.q = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.k = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.v = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.out = nn.Linear(hidden_dim, hidden_dim, bias=False)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c = x.shape
        return x.reshape(n, t, self.heads, c // self.heads)

    def _attend(self, q, k, v, kv_mask, causal):
        n, tq, h, d = q.shape
        s = torch.einsum('nqhd,nkhd->nhqk', q, k) / (d ** 0.5)
        if kv_mask is not None:                   # (N, Tk): True = masked out
            s = s.masked_fill(kv_mask[:, None, None, :], NEG)
        if causal:
            tri = torch.ones(tq, k.shape[1], dtype=torch.bool, device=s.device).triu(1)
            s = s.masked_fill(tri, NEG)
        p = torch.softmax(s, dim=-1)
        return self.out(torch.einsum('nhqk,nkhd->nqhd', p, v).reshape(n, tq, h * d))

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._attend(self._heads(self.q(x_q)), self._heads(self.k(x_kv)),
                            self._heads(self.v(x_kv)), kv_mask, self.causal)

    def kv(self, x_kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project (N, T, C) -> cached K, V of shape (N, T, H, D)."""
        return self._heads(self.k(x_kv)), self._heads(self.v(x_kv))

    def attend_step(self, x_q1: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One query frame (N, 1, C) against cached K / V (N, Tk, H, D)."""
        return self._attend(self._heads(self.q(x_q1)), k_all, v_all, kv_mask, False)


class _FFN(nn.Module):
    """Dense(4C) -> GELU (tanh) -> Dense(C), flax's auto-named Dense_0 / Dense_1."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(hidden_dim, 4 * hidden_dim)
        self.Dense_1 = nn.Linear(4 * hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate='tanh'))


def _named(parent: nn.Module, prefix: str, modules) -> list:
    """Register ``modules`` on ``parent`` as ``<prefix>_<i>`` (the flax
    names) and return them as a list."""
    modules = list(modules)
    for i, m in enumerate(modules):
        parent.add_module('%s_%d' % (prefix, i), m)
    return modules


@register_model('transformer_tts')
class TransformerTTS(nn.Module):
    """Teacher-forced forward: (text_ids (N, Tt), mel_in (N, M, Tm)) ->
    (mel_out (N, M, Tm), stop_logits (N, Tm))."""

    def __init__(self, vocab_size: int = 65, mel_size: int = 80, hidden_dim: int = 256,
                 heads: int = 4, enc_layers: int = 4, dec_layers: int = 4,
                 prenet_dim: int = 128, max_len: int = 4096):
        super().__init__()
        self.vocab_size, self.mel_size = vocab_size, mel_size
        self.hidden_dim, self.heads = hidden_dim, heads
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        c = hidden_dim

        def ln():
            return nn.LayerNorm(c, eps=LAYERNORM_EPS)

        self.embed = nn.Embedding(vocab_size, c)
        self.enc_pe = PositionalEncoding(c, max_len)
        self.dec_pe = PositionalEncoding(c, max_len)
        self.enc_attn = _named(self, 'enc_attn', (_Attention(c, heads) for _ in range(enc_layers)))
        self.enc_ffn = _named(self, 'enc_ffn', (_FFN(c) for _ in range(enc_layers)))
        self.enc_ln = _named(self, 'enc_ln', (ln() for _ in range(2 * enc_layers)))
        self.prenet1 = nn.Linear(mel_size, prenet_dim)
        self.prenet2 = nn.Linear(prenet_dim, c)
        self.dec_self = _named(self, 'dec_self', (_Attention(c, heads, causal=True)
                                                  for _ in range(dec_layers)))
        self.dec_cross = _named(self, 'dec_cross', (_Attention(c, heads)
                                                    for _ in range(dec_layers)))
        self.dec_ffn = _named(self, 'dec_ffn', (_FFN(c) for _ in range(dec_layers)))
        self.dec_ln = _named(self, 'dec_ln', (ln() for _ in range(3 * dec_layers)))
        self.mel_head = nn.Linear(c, mel_size)
        self.stop_head = nn.Linear(c, 1)

    def encode_text(self, text_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, Tt) int ids -> ((N, Tt, C) memory, (N, Tt) pad mask)."""
        pad_mask = text_ids == 0
        x = self.embed(text_ids)                                  # (N, Tt, C)
        x = self.enc_pe(x.transpose(1, 2)).transpose(1, 2)
        for i in range(self.enc_layers):
            x = self.enc_ln[2 * i](x + self.enc_attn[i](x, x, kv_mask=pad_mask))
            x = self.enc_ln[2 * i + 1](x + self.enc_ffn[i](x))
        return x, pad_mask

    def _prenet(self, y: torch.Tensor) -> torch.Tensor:
        return F.relu(self.prenet2(F.relu(self.prenet1(y))))

    def decode_mel(self, memory: torch.Tensor, pad_mask: torch.Tensor,
                   mel_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decode: mel_in (N, M, Tm) (shifted targets)."""
        y = self._prenet(mel_in.transpose(1, 2))                  # (N, Tm, C)
        y = self.dec_pe(y.transpose(1, 2)).transpose(1, 2)
        for i in range(self.dec_layers):
            y = self.dec_ln[3 * i](y + self.dec_self[i](y, y))
            y = self.dec_ln[3 * i + 1](y + self.dec_cross[i](y, memory, kv_mask=pad_mask))
            y = self.dec_ln[3 * i + 2](y + self.dec_ffn[i](y))
        return self.mel_head(y).transpose(1, 2), self.stop_head(y)[..., 0]

    def precompute_cross_kv(self, memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every cross-attention layer's K / V of the encoder memory, once:
        stacked (L, N, Tt, H, D) keys and values."""
        ks, vs = zip(*(attn.kv(memory) for attn in self.dec_cross))
        return torch.stack(ks), torch.stack(vs)

    def decode_step(self, mem_k: torch.Tensor, mem_v: torch.Tensor, pad_mask: torch.Tensor,
                    y_frame: torch.Tensor, t: int, self_k: torch.Tensor,
                    self_v: torch.Tensor):
        """One autoregressive decoder step with KV caches, O(t) per frame.

        ``y_frame`` (N, M) is the previous mel frame and ``t`` its position;
        ``self_k`` / ``self_v`` are (L, N, Tmax, H, D) caches holding the
        positions before t, written here at t (in place) and returned. The
        self-attention reads the caches' first t + 1 positions: the JAX
        step's mask of the later ones (``arange(Tmax) > t``) gives those
        exact zeros. Returns (mel_frame (N, M), stop_logit (N,), self_k,
        self_v), :meth:`decode_mel`'s column t.
        """
        y = self._prenet(y_frame[:, None, :])                     # (N, 1, C)
        y = y * (self.hidden_dim ** 0.5) + self.dec_pe.pe[:, :, t][:, None, :]
        for i in range(self.dec_layers):
            k1, v1 = self.dec_self[i].kv(y)                       # (N, 1, H, D)
            self_k[i, :, t] = k1[:, 0]
            self_v[i, :, t] = v1[:, 0]
            y = self.dec_ln[3 * i](y + self.dec_self[i].attend_step(
                y, self_k[i, :, :t + 1], self_v[i, :, :t + 1]))
            y = self.dec_ln[3 * i + 1](y + self.dec_cross[i].attend_step(
                y, mem_k[i], mem_v[i], kv_mask=pad_mask))
            y = self.dec_ln[3 * i + 2](y + self.dec_ffn[i](y))
        return self.mel_head(y)[:, 0], self.stop_head(y)[:, 0, 0], self_k, self_v

    def forward(self, text_ids: torch.Tensor, mel_in: torch.Tensor):
        memory, pad_mask = self.encode_text(text_ids)
        return self.decode_mel(memory, pad_mask, mel_in)


@torch.inference_mode()
def synthesize(model: TransformerTTS, text_ids, max_frames: int = 400,
               stop_threshold: float = 0.5, go_frame_value: float = None) -> torch.Tensor:
    """Greedy autoregressive inference: (N, Tt) ids -> (N, M, <= max_frames - 1)
    mel, on the model's device and in its dtype.

    The JAX function's loop, frame by frame with KV caches: from a go frame
    (``db_to_log(-50)``), each step decodes the next frame and a row stops
    once its stop probability exceeds ``stop_threshold``; the loop ends when
    every row has stopped or after ``max_frames - 1`` frames. The host reads
    the stop flags every ``STOP_CHECK_FRAMES`` frames, not every frame, and
    the output is trimmed to the first frame at which every row had stopped:
    later frames never change earlier ones, so the frames and their count
    are the JAX loop's.
    """
    weight = next(model.parameters())
    dev, dtype = weight.device, weight.dtype
    text_ids = torch.as_tensor(text_ids).to(dev).long()
    n, m, c, h = text_ids.shape[0], model.mel_size, model.hidden_dim, model.heads
    go = db_to_log(-50.0) if go_frame_value is None else go_frame_value

    memory, pad_mask = model.encode_text(text_ids)
    mem_k, mem_v = model.precompute_cross_kv(memory)
    kv_shape = (model.dec_layers, n, max_frames, h, c // h)
    self_k = torch.zeros(kv_shape, dtype=dtype, device=dev)
    self_v = torch.zeros(kv_shape, dtype=dtype, device=dev)
    mel_buf = torch.full((n, m, max_frames), go, dtype=dtype, device=dev)
    stopped = torch.zeros(n, dtype=torch.bool, device=dev)
    all_stopped = torch.zeros(max(max_frames - 1, 0), dtype=torch.bool, device=dev)
    steps = 0
    for t in range(max_frames - 1):
        out, stop, self_k, self_v = model.decode_step(
            mem_k, mem_v, pad_mask, mel_buf[:, :, t], t, self_k, self_v)
        mel_buf[:, :, t + 1] = out
        stopped = stopped | (torch.sigmoid(stop) > stop_threshold)
        all_stopped[t] = stopped.all()
        steps = t + 1
        if steps % STOP_CHECK_FRAMES == 0 and bool(all_stopped[t]):
            break
    done = torch.nonzero(all_stopped[:steps]).flatten()
    produced = int(done[0]) + 1 if done.numel() else steps
    return mel_buf[:, :, 1:produced + 1]


@register_model_architecture('transformer_tts', 'transformer_tts_base')
def transformer_tts_base():
    return {'vocab_size': 65, 'mel_size': 80, 'hidden_dim': 256, 'heads': 4,
            'enc_layers': 4, 'dec_layers': 4, 'prenet_dim': 128}


@register_model_architecture('transformer_tts', 'transformer_tts_small')
def transformer_tts_small():
    return {'vocab_size': 65, 'mel_size': 80, 'hidden_dim': 64, 'heads': 2,
            'enc_layers': 1, 'dec_layers': 1, 'prenet_dim': 32}
