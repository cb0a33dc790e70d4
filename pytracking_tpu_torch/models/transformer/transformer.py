"""DETR-style post-norm transformer used by ToMP and TaMOs (counterpart of
pytracking_tpu/models/transformer/transformer.py).

Batch-first (B, L, C). Positional embeddings are added to queries and keys
only. The layer stacks are ModuleLists (the JAX package scans one layer over
stacked parameters; `utils/convert_weights.py` unstacks them).

Mixed precision mirrors the JAX package: with `dtype=torch.bfloat16` the
projections, the feed-forward layers and the attention run in bf16 while
parameters stay float32; softmax and LayerNorm run in float32, and the
residual stream stays float32.

Train mode (`module.train()`, flax's `train=True`) drops where flax drops,
at rate `dropout`: each attention block's output, the feed-forward ReLU's
output and the feed-forward output before their residual adds, and the
attention weights after the softmax, with one (Lq, Lk) mask shared over the
batch and the heads (flax's broadcast_dropout). Kept values are scaled by
1 / (1 - dropout). Every mask is drawn from the `generator` passed to
`forward`, never from torch's global generator: a train-mode forward with
dropout and no generator raises.

Attention routing: in eval mode, self-attention with Lq = Lk >= 256 and a
head dim the kernel is built for (`fused_mha.HEAD_DIMS`: 32, the TaMOs
encoder's) goes through `ops.fused_mha.fused_self_attention`, in bf16 and
in float32: on a CUDA tensor that is the hand-written kernel, on a CPU
tensor its plain version. The kernel has no backward, so train mode always
takes the plain matmul + softmax, as the JAX package takes its kernel only
when `deterministic`. Everything else (the decoder's object queries, short
sequences, other head dims) is the plain attention that flax computes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.ops.fused_mha import HEAD_DIMS, fused_self_attention

FUSED_MIN_LEN = 256
LN_EPS = 1e-6          # flax LayerNorm's default (torch's is 1e-5)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _keep_mask(shape, keep_prob: float, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    """Bernoulli(keep_prob) draws of `shape` from `generator`, as
    jax.random.bernoulli draws them: uniform < keep_prob."""
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit torch.Generator; "
                         "pass `generator`")
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's nn.Dropout: each element kept with probability 1 - rate and
    then divided by it, the mask drawn from `generator`."""
    keep_prob = 1.0 - rate
    keep = _keep_mask(x.shape, keep_prob, generator, x.device)
    return torch.where(keep, x / keep_prob, 0.0)


def _plain_attention(q, k, v, keep: Optional[torch.Tensor], rate: float = 0.0,
                     generator: Optional[torch.Generator] = None):
    """flax's dot_product_attention: (B, L, H, D) in the compute dtype; query
    scaled before QK^T, masked logits set to the dtype's minimum, softmax in
    float32. With `rate` > 0 the weights are multiplied by keep / (1 -
    rate), one (Lq, Lk) mask for every batch entry and head. The float32
    probabilities meet V promoted to float32."""
    dt = q.dtype
    D = q.shape[-1]
    q = q / torch.tensor(math.sqrt(D), dtype=torch.float32).to(dt)      # a host scalar
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if keep is not None:
        logits = logits.masked_fill(~keep[:, None, None, :], torch.finfo(dt).min)
    w = torch.softmax(logits.float(), dim=-1)
    if rate > 0.0:
        keep_prob = 1.0 - rate
        mask = _keep_mask(w.shape[-2:], keep_prob, generator, w.device)
        w = w * (mask.to(dt) / torch.tensor(keep_prob, dtype=dt))
    if dt == torch.float32:
        return torch.einsum("bhqk,bkhd->bqhd", w, v)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float())


class MultiheadAttention(nn.Module):
    """flax MultiHeadDotProductAttention: separate query/key/value projections
    d -> (H, d/H) and an output projection (H, d/H) -> d, all with bias; in
    train mode the attention weights drop at rate `dropout`."""

    def __init__(self, d_model: int, nhead: int, dtype: Optional[torch.dtype] = None,
                 dropout: float = 0.1):
        super().__init__()
        self.nhead = nhead
        self.dtype = dtype or torch.float32
        self.dropout = dropout
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """q (B, Lq, C), k/v (B, Lk, C); key_padding_mask (B, Lk) True = ignore;
        `generator` draws the dropout masks in train mode."""
        B, Lq, C = q.shape
        Lk = k.shape[1]
        H = self.nhead
        D = C // H
        dt = self.dtype
        qh = _linear(self.query, q, dt).view(B, Lq, H, D)
        kh = _linear(self.key, k, dt).view(B, Lk, H, D)
        vh = _linear(self.value, v, dt).view(B, Lk, H, D)
        keep = None if key_padding_mask is None else ~key_padding_mask
        if not self.training and Lq == Lk and Lq >= FUSED_MIN_LEN and D in HEAD_DIMS:
            o = fused_self_attention(qh, kh, vh, key_keep_mask=keep)
        else:
            rate = self.dropout if self.training else 0.0
            o = _plain_attention(qh, kh, vh, keep, rate, generator)
        return _linear(self.out, o.reshape(B, Lq, C), dt)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, LN_EPS)


class _Layer(nn.Module):
    """What the encoder and decoder layers share: the dtype, the dropout
    rate and the dropout of train mode."""

    def __init__(self, dropout: float, dtype: Optional[torch.dtype]):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.dropout = dropout

    def _drop(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.dropout == 0.0:
            return x
        return dropout(x, self.dropout, generator)

    def _feed_forward(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        ff = self._drop(F.relu(_linear(self.linear1, x, self.dtype)), generator)
        return self._drop(_linear(self.linear2, ff, self.dtype), generator)


class TransformerEncoderLayer(_Layer):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__(dropout, dtype)
        self.self_attn = MultiheadAttention(d_model, nhead, dtype, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, key_padding_mask=None, generator=None):
        q = src + pos
        src2 = self.self_attn(q, q, src, key_padding_mask, generator)
        src = _layer_norm(self.norm1, src + self._drop(src2, generator))
        return _layer_norm(self.norm2, src + self._feed_forward(src, generator))


class TransformerDecoderLayer(_Layer):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__(dropout, dtype)
        self.self_attn = MultiheadAttention(d_model, nhead, dtype, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MultiheadAttention(d_model, nhead, dtype, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None,
                generator=None):
        q = tgt + query_pos
        tgt2 = self.self_attn(q, q, tgt, generator=generator)
        tgt = _layer_norm(self.norm1, tgt + self._drop(tgt2, generator))
        tgt2 = self.cross_attn(tgt + query_pos, memory + pos, memory,
                               memory_key_padding_mask, generator)
        tgt = _layer_norm(self.norm2, tgt + self._drop(tgt2, generator))
        return _layer_norm(self.norm3, tgt + self._feed_forward(tgt, generator))


class Transformer(nn.Module):
    def __init__(self, d_model: int = 512, nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model = d_model
        self.encoder = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout, dtype)
            for _ in range(num_encoder_layers))
        self.decoder = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout, dtype)
            for _ in range(num_decoder_layers))
        self.dec_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, query_embed, pos, key_padding_mask=None,
                generator: Optional[torch.Generator] = None):
        """src (B, L, C); query_embed (Q, C); pos (B, L, C); key_padding_mask
        (B, L) True = ignore; `generator` draws the dropout masks in train
        mode. Returns (decoder output (B, Q, C), encoder memory (B, L, C))."""
        memory = src
        for layer in self.encoder:
            memory = layer(memory, pos, key_padding_mask, generator)
        B = src.shape[0]
        query_pos = query_embed[None].expand(B, -1, -1)
        tgt = torch.zeros_like(query_pos, dtype=src.dtype)
        for layer in self.decoder:
            tgt = layer(tgt, memory, pos, query_pos, key_padding_mask, generator)
        return _layer_norm(self.dec_norm, tgt), memory
