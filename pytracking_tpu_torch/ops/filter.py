"""Per-sample filter application and its adjoint (counterpart of
pytracking_tpu/ops/filter.py: `apply_filter`, `apply_feat_transpose`,
`filter_gradient`).

Two layouts, each one grouped convolution:
  * per sample: feat (B, C, H, W) with filt (B, K, C, fh, fw) -> (B, K, Ho, Wo);
  * N images per sequence: feat (N, S, C, H, W) with filt (S, K, C, fh, fw)
    -> (N, S, K, Ho, Wo), every image of sequence s correlated with the same
    filter (what the JAX optimizer gets by vmapping over N).

The filter optimisers with S > 1 sequences (LWL's objects, the batched
server's streams) take the `*_per_sequence` forms instead: one ungrouped
convolution per sequence. cuDNN's grouped convolutions with one output
channel per group, and their weight gradients, made a 32-stream DiMP refit
4.3x slower on an H100 (PERF.md §6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def apply_filter(feat: torch.Tensor, filt: torch.Tensor, mode: str = "dimp") -> torch.Tensor:
    """Cross-correlate each sample (or sequence) with its own filter.

    mode='dimp' pads fh//2, fw//2 on both sides, so an even filter gives
    H+1 rows (DiMP's centred score grid); mode='same' then drops the
    trailing row/column of an even filter, so the output is H x W."""
    if mode not in ("dimp", "same"):
        raise ValueError(f"unknown apply_filter mode {mode!r}")
    per_sample = feat.dim() == 4
    if per_sample:
        feat = feat[None]
    N, S, C, H, W = feat.shape
    _, K, _, fh, fw = filt.shape
    out = F.conv2d(feat.reshape(N, S * C, H, W), filt.reshape(S * K, C, fh, fw),
                   padding=(fh // 2, fw // 2), groups=S)
    out = out.reshape(N, S, K, out.shape[-2], out.shape[-1])
    if mode == "same":
        out = out[..., :H, :W]
    return out[0] if per_sample else out


def apply_feat_transpose(feat: torch.Tensor, activations: torch.Tensor,
                         filter_shape) -> torch.Tensor:
    """The adjoint of `apply_filter` (mode 'dimp') in the filter: the
    gradient of <apply_filter(feat, w), activations> with respect to w.

    Written as one grouped correlation of the zero-padded features with the
    activation maps, the maps as kernels: the channels C become the batch,
    the images (N) of each sequence the contracted input channels, the
    sequences the groups. feat (B, C, H, W) with activations (B, K, Ho, Wo)
    gives (B, K, C, fh, fw); feat (N, S, C, H, W) with activations
    (N, S, K, Ho, Wo) gives (S, K, C, fh, fw), summed over the N images."""
    fh, fw = int(filter_shape[0]), int(filter_shape[1])
    per_sample = feat.dim() == 4
    if per_sample:
        feat, activations = feat[None], activations[None]
    N, S, C, H, W = feat.shape
    K, Ho, Wo = activations.shape[2:]
    x = feat.permute(2, 1, 0, 3, 4).reshape(C, S * N, H, W)
    k = activations.permute(1, 2, 0, 3, 4).reshape(S * K, N, Ho, Wo)
    out = F.conv2d(x, k, padding=(fh // 2, fw // 2), groups=S)       # (C, S*K, fh, fw)
    return out.reshape(C, S, K, fh, fw).permute(1, 2, 0, 3, 4)


def apply_filter_per_sequence(feat: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """`apply_filter` of feat (N, S, C, H, W) with filt (S, K, C, fh, fw),
    one convolution per sequence."""
    outs = [apply_filter(feat[:, s:s + 1], filt[s:s + 1]) for s in range(feat.shape[1])]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def apply_feat_transpose_per_sequence(feat: torch.Tensor, activations: torch.Tensor,
                                      filter_shape) -> torch.Tensor:
    """`apply_feat_transpose` of feat (N, S, C, H, W) with activations
    (N, S, K, Ho, Wo), one convolution per sequence."""
    outs = [apply_feat_transpose(feat[:, s:s + 1], activations[:, s:s + 1], filter_shape)
            for s in range(feat.shape[1])]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def filter_gradient(feat: torch.Tensor, filt: torch.Tensor,
                    label: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of the L2 classification loss 0.5 |apply_filter(feat, filt)
    - label|^2 with respect to the filter."""
    residuals = apply_filter(feat, filt)
    if label is not None:
        residuals = residuals - label
    return apply_feat_transpose(feat, residuals, filt.shape[-2:])
