"""LWL target model: a 3x3 convolution whose weights the few-shot learner
fits to the label encoding (counterpart of
pytracking_tpu/models/lwl/linear_filter.py: `lwl_residual`,
`LWLLinearFilter`'s tracking-time methods).

The learner minimises |W(y)·(T_τ(x) − E(y))|² + λ|τ|² by the generic
Gauss-Newton steepest descent (`models/meta/steepestdescent.py`).

Shapes: feat (N, S, C, H, W), N images of S sequences; label and sample
weights (N, S, K, H, W); the filter (S, K, C, fs, fs).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pytracking_tpu_torch.models.meta.steepestdescent import gn_steepest_descent
from pytracking_tpu_torch.ops.filter import apply_filter, apply_filter_per_sequence


def lwl_residual(filt: torch.Tensor, feat: torch.Tensor, label: torch.Tensor,
                 sample_weight: Optional[torch.Tensor], filter_reg: torch.Tensor) -> dict:
    """The few-shot residuals: weighted data term and filter regulariser."""
    N, S = feat.shape[:2]
    sw = math.sqrt(1.0 / N) if sample_weight is None else sample_weight
    return {"data": sw * (apply_filter_per_sequence(feat, filt) - label),
            "reg": filter_reg * filt.reshape(1, S, -1)}


class LWLLinearFilter(nn.Module):
    """The target model of LWL, RTS and STA. `feature_extractor` (backbone
    feature -> target-model feature) may be None where another target
    model of the net owns the shared one (STA's refined model)."""

    def __init__(self, filter_size: int = 3, num_filters: int = 16, feature_dim: int = 512,
                 num_iter: int = 5, init_filter_reg: float = 1e-2,
                 feature_extractor: Optional[nn.Module] = None):
        super().__init__()
        self.filter_size = filter_size
        self.num_filters = num_filters
        self.feature_dim = feature_dim
        self.num_iter = num_iter
        self.filter_reg = nn.Parameter(torch.full((1,), float(init_filter_reg)))
        self.feature_extractor = feature_extractor

    def extract_target_model_features(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) or (N, S, C, H, W) backbone feature -> target-model
        feature."""
        if feat.dim() == 5:
            out = self.feature_extractor(feat.flatten(0, 1))
            return out.reshape(feat.shape[:2] + out.shape[1:])
        return self.feature_extractor(feat)

    def apply_target_model(self, weights: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """(N, S, C, H, W) with (S, K, C, fs, fs) -> mask encoding (N, S, K, H, W)."""
        return apply_filter(feat, weights)

    def get_filter(self, feat: torch.Tensor, label: torch.Tensor,
                   sample_weight: Optional[torch.Tensor] = None,
                   num_iter: Optional[int] = None) -> torch.Tensor:
        """The filter fitted from zero over `num_iter` steps (default the
        module's)."""
        num_iter = self.num_iter if num_iter is None else num_iter
        S = feat.shape[1]
        w0 = feat.new_zeros((S, self.num_filters, self.feature_dim, self.filter_size,
                             self.filter_size))
        return self.update_filter(w0, feat, label, sample_weight, num_iter)

    def update_filter(self, filt: torch.Tensor, feat: torch.Tensor, label: torch.Tensor,
                      sample_weight: Optional[torch.Tensor] = None,
                      num_iter: int = 2) -> torch.Tensor:
        """`num_iter` more steps from `filt` on (feat, label, sample_weight)."""
        reg = self.filter_reg[0]
        return gn_steepest_descent(
            lambda w: lwl_residual(w, feat, label, sample_weight, reg), filt, num_iter,
            residual_batch_dim=1)
