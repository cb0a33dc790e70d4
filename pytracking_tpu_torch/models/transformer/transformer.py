"""DETR-style post-norm transformer used by TaMOs (counterpart of
pytracking_tpu/models/transformer/transformer.py).

Batch-first (B, L, C). Positional embeddings are added to queries and keys
only. The layer stacks are ModuleLists (the JAX package scans one layer over
stacked parameters; `utils/convert_weights.py` unstacks them).

Mixed precision mirrors the JAX package: with `dtype=torch.bfloat16` the
projections, the feed-forward layers and the attention run in bf16 while
parameters stay float32; softmax and LayerNorm run in float32, and the
residual stream stays float32.

Attention routing: self-attention with Lq = Lk >= 256 and a head dim the
kernel is built for (`fused_mha.HEAD_DIMS`: 32, the TaMOs encoder's) goes
through `ops.fused_mha.fused_self_attention`, in bf16 and in float32: on a
CUDA tensor that is the hand-written kernel, on a CPU tensor its plain
version. Everything else (the decoder's 10 object queries, short sequences,
other head dims) is the plain matmul + softmax that flax computes.
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


def _plain_attention(q, k, v, keep: Optional[torch.Tensor]):
    """flax's dot_product_attention: (B, L, H, D) in the compute dtype; query
    scaled before QK^T, masked logits set to the dtype's minimum, softmax in
    float32. The float32 probabilities meet V promoted to float32."""
    dt = q.dtype
    D = q.shape[-1]
    q = q / torch.tensor(math.sqrt(D), dtype=torch.float32).to(dt)      # a host scalar
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if keep is not None:
        logits = logits.masked_fill(~keep[:, None, None, :], torch.finfo(dt).min)
    w = torch.softmax(logits.float(), dim=-1)
    if dt == torch.float32:
        return torch.einsum("bhqk,bkhd->bqhd", w, v)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float())


class MultiheadAttention(nn.Module):
    """flax MultiHeadDotProductAttention: separate query/key/value projections
    d -> (H, d/H) and an output projection (H, d/H) -> d, all with bias."""

    def __init__(self, d_model: int, nhead: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.nhead = nhead
        self.dtype = dtype or torch.float32
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, key_padding_mask: Optional[torch.Tensor] = None):
        """q (B, Lq, C), k/v (B, Lk, C); key_padding_mask (B, Lk) True = ignore."""
        B, Lq, C = q.shape
        Lk = k.shape[1]
        H = self.nhead
        D = C // H
        dt = self.dtype
        qh = _linear(self.query, q, dt).view(B, Lq, H, D)
        kh = _linear(self.key, k, dt).view(B, Lk, H, D)
        vh = _linear(self.value, v, dt).view(B, Lk, H, D)
        keep = None if key_padding_mask is None else ~key_padding_mask
        if Lq == Lk and Lq >= FUSED_MIN_LEN and D in HEAD_DIMS:
            o = fused_self_attention(qh, kh, vh, key_keep_mask=keep)
        else:
            o = _plain_attention(qh, kh, vh, keep)
        return _linear(self.out, o.reshape(B, Lq, C), dt)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, LN_EPS)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.self_attn = MultiheadAttention(d_model, nhead, dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, key_padding_mask=None):
        q = src + pos
        src = _layer_norm(self.norm1, src + self.self_attn(q, q, src, key_padding_mask))
        ff = _linear(self.linear2, F.relu(_linear(self.linear1, src, self.dtype)),
                     self.dtype)
        return _layer_norm(self.norm2, src + ff)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.self_attn = MultiheadAttention(d_model, nhead, dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MultiheadAttention(d_model, nhead, dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None):
        q = tgt + query_pos
        tgt = _layer_norm(self.norm1, tgt + self.self_attn(q, q, tgt))
        tgt2 = self.cross_attn(tgt + query_pos, memory + pos, memory,
                               memory_key_padding_mask)
        tgt = _layer_norm(self.norm2, tgt + tgt2)
        ff = _linear(self.linear2, F.relu(_linear(self.linear1, tgt, self.dtype)),
                     self.dtype)
        return _layer_norm(self.norm3, tgt + ff)


class Transformer(nn.Module):
    def __init__(self, d_model: int = 512, nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model = d_model
        self.encoder = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dtype)
            for _ in range(num_encoder_layers))
        self.decoder = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, dtype)
            for _ in range(num_decoder_layers))
        self.dec_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, query_embed, pos, key_padding_mask=None):
        """src (B, L, C); query_embed (Q, C); pos (B, L, C); key_padding_mask
        (B, L) True = ignore. Returns (decoder output (B, Q, C), encoder
        memory (B, L, C))."""
        memory = src
        for layer in self.encoder:
            memory = layer(memory, pos, key_padding_mask)
        B = src.shape[0]
        query_pos = query_embed[None].expand(B, -1, -1)
        tgt = torch.zeros_like(query_pos, dtype=src.dtype)
        for layer in self.decoder:
            tgt = layer(tgt, memory, pos, query_pos, key_padding_mask)
        return _layer_norm(self.dec_norm, tgt), memory
