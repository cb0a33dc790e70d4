"""Swin Transformer backbone with flexible input sizes (counterpart of
pytracking_tpu/models/backbones/swin.py: `WindowAttention`, `SwinBlock`,
`SwinTransformer`, `swin_base`, `swin_tiny`).

Inside the backbone the maps are channels last, (B, H, W, C); the stage
outputs are returned NCHW in float32, as the ResNet's are. The arithmetic is
the JAX package's: LayerNorm eps 1e-6, the tanh approximation of GELU, the
logits scaled after QK^T, a relative position bias gathered from a
((2ws-1)^2, heads) table, -100 between the wrapped regions of a shifted
window, and a plain matmul + float32 softmax for the window attention. Each
stage pads its input once to window multiples before its blocks (the padded
tokens go through every block) and crops after them; patch merging crops odd
sizes to even and concatenates the 2x2 neighbours in the order (0,0),
(1,0), (0,1), (1,1).

The shift mask and the relative position index live on the device: the
index is a buffer of each attention, the mask is built once per padded
(H, W) and device and cached. Stages after the last requested output are
built (their weights are part of the model) but not run.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6          # flax LayerNorm's default


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the bias table of each token pair's offset."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws², C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def _window_reverse(windows: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    C = windows.shape[-1]
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


@functools.cache
def shift_mask(H: int, W: int, ws: int, device) -> torch.Tensor:
    """(nW, ws², ws²) additive mask of a shifted window over a padded (H, W)
    map: -100 between tokens from different wrapped regions, else 0. Cached
    per arguments: callers must not modify the result."""
    shift = ws // 2
    img_mask = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = _window_partition(torch.from_numpy(img_mask), ws)[..., 0]          # (nW, N)
    mask = torch.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)
    return mask.to(device)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, LN_EPS)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(_rel_pos_index(window_size)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x (B_, N, C) with N = ws²; mask (nW, N, N) or None."""
        B_, N, C = x.shape
        heads = self.num_heads
        hd = C // heads
        qkv = self.qkv(x).reshape(B_, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q, k.transpose(-2, -1)) * hd ** -0.5
        bias = self.rel_pos_bias[self.rel_index.reshape(-1)].reshape(N, N, heads)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, heads, N, N) + mask[None, :, None]
                    ).reshape(B_, heads, N, N)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: bool = False,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C), H and W already padded to window multiples."""
        B, H, W, C = x.shape
        ws = self.window_size
        shift = ws // 2 if self.shift else 0
        shortcut = x
        x = _layer_norm(self.norm1, x)
        mask = None
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = shift_mask(H, W, ws, x.device)
        x = _window_reverse(self.attn(_window_partition(x, ws), mask), ws, B, H, W)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x
        y = F.gelu(self.fc1(_layer_norm(self.norm2, x)), approximate="tanh")
        return x + self.fc2(y)


class SwinTransformer(nn.Module):
    """Swin-B by default: embed_dim 128, depths (2, 2, 18, 2), heads
    (4, 8, 16, 32). Returns the requested stages ('stage1'..'stage4',
    strides 4..32) as NCHW float32 maps."""

    def __init__(self, embed_dim: int = 128, depths: Tuple[int, ...] = (2, 2, 18, 2),
                 num_heads: Tuple[int, ...] = (4, 8, 16, 32), window_size: int = 7,
                 output_layers: Sequence[str] = ("stage2", "stage3")):
        super().__init__()
        self.depths = tuple(depths)
        self.window_size = window_size
        self.output_layers = tuple(output_layers)
        self.last_stage = max(int(n[len("stage"):]) for n in self.output_layers)
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.embed_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        dim = embed_dim
        for stage, depth in enumerate(self.depths):
            for b in range(depth):
                self.add_module(f"stage{stage + 1}_block{b}",
                                SwinBlock(dim, num_heads[stage], window_size, shift=b % 2 == 1))
            if stage < len(self.depths) - 1:
                self.add_module(f"merge_norm{stage + 1}", nn.LayerNorm(4 * dim, eps=LN_EPS))
                self.add_module(f"merge_reduce{stage + 1}", nn.Linear(4 * dim, 2 * dim,
                                                                      bias=False))
                dim *= 2

    def _patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        """The stride-4 4x4 convolution with flax's 'SAME' padding."""
        pads = []
        for size in (x.shape[-1], x.shape[-2]):
            total = max((-(-size // 4) - 1) * 4 + 4 - size, 0)
            pads += [total // 2, total - total // 2]
        return self.patch_embed(F.pad(x, pads) if any(pads) else x)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (N, 3, H, W), normalised."""
        outputs = {}
        x = _layer_norm(self.embed_norm, self._patch_embed(x).permute(0, 2, 3, 1))
        ws = self.window_size
        for stage in range(self.last_stage):
            H, W = x.shape[1], x.shape[2]
            xp = F.pad(x, (0, 0, 0, (ws - W % ws) % ws, 0, (ws - H % ws) % ws))
            for b in range(self.depths[stage]):
                xp = getattr(self, f"stage{stage + 1}_block{b}")(xp)
            x = xp[:, :H, :W]
            name = f"stage{stage + 1}"
            if name in self.output_layers:
                outputs[name] = x.permute(0, 3, 1, 2).contiguous()
            if stage + 1 < self.last_stage:
                xm = x[:, :(H // 2) * 2, :(W // 2) * 2]
                xm = torch.cat([xm[:, 0::2, 0::2], xm[:, 1::2, 0::2], xm[:, 0::2, 1::2],
                                xm[:, 1::2, 1::2]], dim=-1)
                x = getattr(self, f"merge_reduce{stage + 1}")(
                    _layer_norm(getattr(self, f"merge_norm{stage + 1}"), xm))
        return outputs


def swin_base(output_layers=("stage2", "stage3")) -> SwinTransformer:
    return SwinTransformer(output_layers=tuple(output_layers))


def swin_tiny(output_layers=("stage2", "stage3")) -> SwinTransformer:
    return SwinTransformer(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                           output_layers=tuple(output_layers))
