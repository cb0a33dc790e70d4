"""DiMP's unrolled steepest-descent Gauss-Newton filter optimiser
(counterpart of pytracking_tpu/models/classifier/optimizer.py
`DiMPSteepestDescentGN`).

Shapes: weights (S, 1, C, fh, fw); feat (N, S, C, H, W); bb (N, S, 4) as
(x, y, w, h) in image-patch coordinates; sample_weight (N, S) or None. The
iteration count is a host integer, so the loop is a plain Python loop of
fixed-shape tensor ops with no readback.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pytracking_tpu_torch.ops import activation as act
from pytracking_tpu_torch.ops.distance import distance_map
from pytracking_tpu_torch.ops.filter import apply_feat_transpose, apply_filter


class DiMPSteepestDescentGN(nn.Module):
    """Steepest descent with a Gauss-Newton step length on the learned
    residual: label map y, target mask m (through a sigmoid) and spatial
    weight v are linear in a binned distance map of the target centre,
    their per-bin weights are parameters; the scores go through the
    parametric leaky ReLU with slope m. The five parameters start at the
    JAX package's structured values (a seeded net learns a usable filter
    from them)."""

    min_filter_reg = 1e-3

    def __init__(self, num_iter: int = 1, feat_stride: int = 16,
                 init_step_length: float = 1.0, init_filter_reg: float = 1e-2,
                 init_gauss_sigma: float = 1.0, num_dist_bins: int = 5,
                 bin_displacement: float = 1.0, mask_init_factor: float = 4.0):
        super().__init__()
        self.num_iter = num_iter
        self.feat_stride = feat_stride
        self.num_dist_bins = num_dist_bins
        self.bin_displacement = bin_displacement

        self.log_step_length = nn.Parameter(torch.full((1,), math.log(init_step_length)))
        self.filter_reg = nn.Parameter(torch.full((1,), float(init_filter_reg)))
        d = torch.arange(num_dist_bins, dtype=torch.float32) * bin_displacement
        init_gauss = torch.exp(-0.5 * (d / init_gauss_sigma) ** 2)
        self.label_map_w = nn.Parameter(init_gauss - init_gauss.min())
        self.target_mask_w = nn.Parameter(mask_init_factor * torch.tanh(2.0 - d))
        self.spatial_weight_w = nn.Parameter(torch.ones(num_dist_bins))

    def _predictors(self, bb: torch.Tensor, filter_sz, output_sz):
        """Label map, target mask and spatial weight, each (N*S, H, W), from
        the distance map of the target centres."""
        center = ((bb[..., :2] + bb[..., 2:] / 2) / self.feat_stride).reshape(-1, 2).flip(-1)
        # (x, y) -> (y, x), less half a cell per odd filter dimension
        center = torch.stack([center[:, 0] - (filter_sz[0] % 2) / 2.0,
                              center[:, 1] - (filter_sz[1] % 2) / 2.0], dim=-1)
        dmap = distance_map(center, output_sz, self.num_dist_bins, self.bin_displacement)
        return (dmap @ self.label_map_w, torch.sigmoid(dmap @ self.target_mask_w),
                dmap @ self.spatial_weight_w)

    def forward(self, weights: torch.Tensor, feat: torch.Tensor, bb: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None,
                num_iter: Optional[int] = None) -> torch.Tensor:
        num_iter = self.num_iter if num_iter is None else num_iter
        N, S = feat.shape[:2]
        fsz = (weights.shape[-2], weights.shape[-1])
        out_sz = (feat.shape[-2] + (fsz[0] + 1) % 2, feat.shape[-1] + (fsz[1] + 1) % 2)

        step_length = torch.exp(self.log_step_length)[0]
        reg = torch.clamp(self.filter_reg * self.filter_reg, min=self.min_filter_reg ** 2)[0]

        label, mask, sw = (x.reshape((N, S, 1) + out_sz)
                           for x in self._predictors(bb, fsz, out_sz))
        if sample_weight is None:
            sample_weight = math.sqrt(1.0 / N) * sw
        else:
            sample_weight = torch.sqrt(sample_weight).reshape(N, S, 1, 1, 1) * sw

        for _ in range(num_iter):
            scores = apply_filter(feat, weights)                          # (N, S, 1, H, W)
            score_mask = act.leaky_relu_par_deriv(scores, mask)
            residuals = sample_weight * (act.leaky_relu_par(scores, mask) - label)
            residuals_mapped = score_mask * (sample_weight * residuals)
            w_grad = apply_feat_transpose(feat, residuals_mapped, fsz) + reg * weights

            scores_grad = sample_weight * (score_mask * apply_filter(feat, w_grad))
            alpha_num = torch.sum(w_grad * w_grad, dim=(1, 2, 3, 4))               # (S,)
            alpha_den = torch.clamp(torch.sum(scores_grad ** 2, dim=(0, 2, 3, 4))
                                    + reg * alpha_num, min=1e-8)
            alpha = alpha_num / alpha_den
            weights = weights - (step_length * alpha)[:, None, None, None, None] * w_grad
        return weights
