"""SuperGlue-style attentional graph net with Sinkhorn optimal transport,
KeepTrack's candidate matcher (counterpart of
pytracking_tpu/models/tcm/superglue.py: `MLP1d`, `normalize_keypoints`,
`KeypointEncoder`, `MultiHeadedAttention`, `AttentionalPropagation`,
`AttentionalGNN`, `log_sinkhorn_iterations`, `log_optimal_transport`,
`SuperGlueMatcher`).

Tokens are (B, N, C). The candidate sets have a fixed slot count with a
validity mask: invalid slots take part in the graph net like valid ones
and get a similarity of -1e4, so optimal transport sends them to the
dustbin.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.models.layers.blocks import BatchNorm


class MLP1d(nn.Module):
    """Tokenwise MLP, BatchNorm and ReLU between the layers (BatchNorm over
    the flattened tokens, per channel)."""

    def __init__(self, in_dim: int, dims: Sequence[int]):
        super().__init__()
        self.n = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"lin{i}", nn.Linear(in_dim, d))
            if i < self.n - 1:
                self.add_module(f"bn{i}", BatchNorm(d, dim=-1))
            in_dim = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"lin{i}")(x)
            if i < self.n - 1:
                x = F.relu(getattr(self, f"bn{i}")(x))
        return x


def normalize_keypoints(kpts: torch.Tensor, image_shape: Tuple[int, int]) -> torch.Tensor:
    """(x, y) image coordinates, centred and scaled by 0.7 of the larger
    image side."""
    h, w = image_shape
    centred = torch.stack([kpts[..., 0] - w / 2, kpts[..., 1] - h / 2], dim=-1)
    return centred / (max(w, h) * 0.7)


class KeypointEncoder(nn.Module):
    """(x, y, score) -> an embedding in the descriptor space."""

    def __init__(self, feature_dim: int, layers: Sequence[int] = (32, 64, 128, 256)):
        super().__init__()
        self.encoder = MLP1d(3, tuple(layers) + (feature_dim,))

    def forward(self, kpts: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
        return self.encoder(torch.cat([kpts, scores[..., None]], dim=-1))


class MultiHeadedAttention(nn.Module):
    """Attention whose channels split as (head_dim, heads), the head index
    fastest, as the reference's torch layout does."""

    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        self.num_heads = num_heads
        self.dim = d_model // num_heads
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.merge = nn.Linear(d_model, d_model)

    def forward(self, query, key, value):
        def split(x):
            return x.reshape(x.shape[:-1] + (self.dim, self.num_heads))

        q, k, v = split(self.proj_q(query)), split(self.proj_k(key)), split(self.proj_v(value))
        scores = torch.einsum("bndh,bmdh->bhnm", q, k) / math.sqrt(self.dim)
        out = torch.einsum("bhnm,bmdh->bndh", torch.softmax(scores, dim=-1), v)
        return self.merge(out.reshape(out.shape[:-2] + (-1,)))


class AttentionalPropagation(nn.Module):
    def __init__(self, d_model: int, num_heads: int = 4):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, d_model)
        self.mlp = MLP1d(2 * d_model, (2 * d_model, d_model))

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        return self.mlp(torch.cat([x, self.attn(x, source, source)], dim=-1))


class AttentionalGNN(nn.Module):
    """Alternating self and cross layers; each layer updates both sets."""

    def __init__(self, feature_dim: int, layer_types: Sequence[str]):
        super().__init__()
        self.layer_types = tuple(layer_types)
        for i in range(len(self.layer_types)):
            self.add_module(f"layer{i}", AttentionalPropagation(feature_dim))

    def forward(self, desc0: torch.Tensor, desc1: torch.Tensor):
        for i, kind in enumerate(self.layer_types):
            layer = getattr(self, f"layer{i}")
            src0, src1 = (desc1, desc0) if kind == "cross" else (desc0, desc1)
            desc0, desc1 = desc0 + layer(desc0, src0), desc1 + layer(desc1, src1)
        return desc0, desc1


def log_sinkhorn_iterations(Z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                            iters: int) -> torch.Tensor:
    """Sinkhorn normalisation in log space, `iters` row-column passes."""
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor, iters: int) -> torch.Tensor:
    """Optimal transport with a dustbin row and column of score `alpha`:
    scores (B, M, N) -> the log assignment (B, M+1, N+1)."""
    b, m, n = scores.shape
    alpha = alpha.to(scores.dtype)
    couplings = torch.cat([torch.cat([scores, alpha.expand(b, m, 1)], -1),
                           torch.cat([alpha.expand(b, 1, n), alpha.expand(b, 1, 1)], -1)], 1)
    norm = -math.log(m + n)
    log_mu = torch.full((b, m + 1), norm, dtype=scores.dtype, device=scores.device)
    log_mu[:, m] = math.log(n) + norm
    log_nu = torch.full((b, n + 1), norm, dtype=scores.dtype, device=scores.device)
    log_nu[:, n] = math.log(m) + norm
    return log_sinkhorn_iterations(couplings, log_mu, log_nu, iters) - norm


class SuperGlueMatcher(nn.Module):
    """Keypoint encoding, the graph net, the final projection, the
    similarity with invalid slots at -1e4, and optimal transport."""

    def __init__(self, input_dim: int = 256, descriptor_dim: int = 256,
                 keypoint_encoder: Sequence[int] = (32, 64, 128, 256), num_gnn_layers: int = 9,
                 num_sinkhorn_iterations: int = 10, image_shape: Tuple[int, int] = (288, 288)):
        super().__init__()
        self.descriptor_dim = descriptor_dim
        self.num_sinkhorn_iterations = num_sinkhorn_iterations
        self.image_shape = tuple(image_shape)
        self.input_proj = nn.Linear(input_dim, descriptor_dim) \
            if input_dim != descriptor_dim else None
        self.kenc = KeypointEncoder(descriptor_dim, keypoint_encoder)
        self.gnn = AttentionalGNN(descriptor_dim, ("self", "cross") * num_gnn_layers)
        self.final_proj = nn.Linear(descriptor_dim, descriptor_dim)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def forward(self, img_coords0, img_coords1, desc0, desc1, scores0, scores1,
                valid0=None, valid1=None) -> dict:
        """coords (B, K, 2) as (x, y) image coordinates; desc (B, K, C);
        scores (B, K); valid (B, K) bool. Returns the log assignment (B,
        K+1, K+1), the match probabilities and the similarity."""
        if self.input_proj is not None:
            desc0, desc1 = self.input_proj(desc0), self.input_proj(desc1)
        desc0 = desc0 + self.kenc(normalize_keypoints(img_coords0, self.image_shape), scores0)
        desc1 = desc1 + self.kenc(normalize_keypoints(img_coords1, self.image_shape), scores1)
        desc0, desc1 = self.gnn(desc0, desc1)
        mdesc0, mdesc1 = self.final_proj(desc0), self.final_proj(desc1)
        sim = torch.einsum("bnd,bmd->bnm", mdesc0, mdesc1) / self.descriptor_dim ** 0.5
        if valid0 is not None:
            sim = torch.where(valid0[:, :, None], sim, -1e4)
        if valid1 is not None:
            sim = torch.where(valid1[:, None, :], sim, -1e4)
        log_assignment = log_optimal_transport(sim, self.bin_score,
                                               self.num_sinkhorn_iterations)
        return {"log_assignment": log_assignment,
                "matches0_prob": torch.exp(log_assignment[:, :-1, :-1]), "similarity": sim}
