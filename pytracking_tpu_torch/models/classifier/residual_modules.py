"""Residual-module filter optimisers of DiMP-simple and of RTS's classifier
(counterpart of pytracking_tpu/models/classifier/residual_modules.py
`GNSteepestDescentDiMP`, `GNSteepestDescentHinge`).

DiMP's learned label map, target mask and spatial weight (linear in a
binned distance map of the target centre) define the residual; the generic
Gauss-Newton steepest descent (`models/meta/steepestdescent.py`) minimises
it with Jacobian products by `torch.func`. The interface is
`DiMPSteepestDescentGN`'s, so `LinearFilter` and the tracker take either.

RTS's hinge optimiser takes its regression labels from the tracker and
its target mask from a hinge on them, over the same generic descent.

Shapes: weights (S, 1, C, fh, fw); feat (N, S, C, H, W); bb (N, S, 4) as
(x, y, w, h); sample_weight (N, S) or None.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pytracking_tpu_torch.models.classifier.optimizer import initial_label_map_w
from pytracking_tpu_torch.models.meta.steepestdescent import gn_steepest_descent
from pytracking_tpu_torch.ops import activation as act
from pytracking_tpu_torch.ops.distance import distance_map
from pytracking_tpu_torch.ops.filter import apply_filter, apply_filter_per_sequence


class GNSteepestDescentDiMP(nn.Module):
    """The residual: sample weight x (bent_identity(scores, mask) - label),
    and filter_reg x the filter. The mask passes through a sigmoid."""

    def __init__(self, num_iter: int = 1, feat_stride: int = 16,
                 init_filter_reg: float = 1e-2, init_gauss_sigma: float = 1.0,
                 num_dist_bins: int = 5, bin_displacement: float = 1.0,
                 mask_init_factor: float = 4.0, act_param: Optional[float] = None):
        super().__init__()
        self.num_iter = num_iter
        self.feat_stride = feat_stride
        self.num_dist_bins = num_dist_bins
        self.bin_displacement = bin_displacement
        self.act_param = act_param or 1.0

        d = torch.arange(num_dist_bins, dtype=torch.float32) * bin_displacement
        self.filter_reg = nn.Parameter(torch.full((1,), float(init_filter_reg)))
        self.label_map_w = nn.Parameter(initial_label_map_w(d, init_gauss_sigma))
        self.target_mask_w = nn.Parameter(mask_init_factor * torch.tanh(2.0 - d))
        self.spatial_weight_w = nn.Parameter(torch.ones(num_dist_bins))

    def forward(self, weights: torch.Tensor, feat: torch.Tensor, bb: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None,
                num_iter: Optional[int] = None, return_iterates: bool = False,
                compute_losses: bool = False):
        """The filter after `num_iter` steps; with `return_iterates` the
        triple (weights, w_iters, losses) of `gn_steepest_descent`, which
        the training forward differentiates through."""
        num_iter = self.num_iter if num_iter is None else num_iter
        N, S = feat.shape[:2]
        out_sz = (feat.shape[-2] + (weights.shape[-2] + 1) % 2,
                  feat.shape[-1] + (weights.shape[-1] + 1) % 2)

        center = ((bb[..., :2] + bb[..., 2:] / 2) / self.feat_stride).reshape(-1, 2).flip(-1)
        dmap = distance_map(center, out_sz, self.num_dist_bins, self.bin_displacement)
        shape_ns = (N, S, 1) + out_sz
        label = (dmap @ self.label_map_w).reshape(shape_ns)
        mask = torch.sigmoid(dmap @ self.target_mask_w).reshape(shape_ns)
        sw = (dmap @ self.spatial_weight_w).reshape(shape_ns)
        if sample_weight is None:
            sample_weight = math.sqrt(1.0 / N) * sw
        else:
            sample_weight = torch.sqrt(sample_weight).reshape(N, S, 1, 1, 1) * sw
        reg = self.filter_reg[0]

        def residual(w):
            scores = act.bent_ident_par(apply_filter_per_sequence(feat, w), mask,
                                        self.act_param)
            return {"data": sample_weight * (scores - label), "reg": reg * w.reshape(1, S, -1)}

        return gn_steepest_descent(residual, weights, num_iter, residual_batch_dim=1,
                                   return_iterates=return_iterates,
                                   compute_losses=compute_losses)


class GNSteepestDescentHinge(nn.Module):
    """The residual: sample weight x (act(scores, mask) - mask x label),
    and filter_reg x the filter, with external labels (N, S, H', W') on the
    score grid and the target mask min(1, [label > hinge_threshold] +
    activation_leak). `score_act` 'bentpar' is the bent identity (parameter
    `act_param`, default 1), anything else the parametric leaky ReLU.
    Without `learn_filter_reg` the regulariser is a constant, not a
    parameter."""

    def __init__(self, num_iter: int = 1, feat_stride: int = 16, init_filter_reg: float = 1e-2,
                 hinge_threshold: float = -999.0, activation_leak: float = 0.0,
                 score_act: str = "bentpar", act_param: Optional[float] = None,
                 learn_filter_reg: bool = True, steplength_reg: float = 0.0):
        super().__init__()
        self.num_iter = num_iter
        self.feat_stride = feat_stride
        self.hinge_threshold = hinge_threshold
        self.activation_leak = activation_leak
        self.score_act = score_act
        self.act_param = act_param or 1.0
        self.steplength_reg = steplength_reg
        self.filter_reg = nn.Parameter(torch.full((1,), float(init_filter_reg))) \
            if learn_filter_reg else float(init_filter_reg)

    def forward(self, weights: torch.Tensor, feat: torch.Tensor, bb=None,
                train_label: Optional[torch.Tensor] = None,
                sample_weight: Optional[torch.Tensor] = None,
                num_iter: Optional[int] = None) -> torch.Tensor:
        num_iter = self.num_iter if num_iter is None else num_iter
        N, S = feat.shape[:2]
        label = train_label.reshape(N, S, 1, train_label.shape[-2], train_label.shape[-1])
        if sample_weight is None:
            sw = math.sqrt(1.0 / N)
        else:
            sw = torch.sqrt(sample_weight).reshape(N, -1, 1, 1, 1)
        target_mask = torch.clamp((label > self.hinge_threshold).to(feat.dtype)
                                  + self.activation_leak, max=1.0)
        reg = self.filter_reg[0] if isinstance(self.filter_reg, nn.Parameter) else self.filter_reg

        def s_act(s):
            if self.score_act == "bentpar":
                return act.bent_ident_par(s, target_mask, self.act_param)
            return act.leaky_relu_par(s, target_mask)

        def residual(w):
            data = sw * (s_act(apply_filter(feat, w)) - target_mask * label)
            return {"data": data, "reg": reg * w.reshape(1, S, -1)}

        return gn_steepest_descent(residual, weights, num_iter, residual_batch_dim=1,
                                   steplength_reg=self.steplength_reg)
