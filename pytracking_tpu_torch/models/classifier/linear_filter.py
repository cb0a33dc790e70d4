"""Target classification filter: feature block, initialiser and optimiser
(counterpart of pytracking_tpu/models/classifier/linear_filter.py, the
tracking-time methods)."""

from __future__ import annotations

import torch
from torch import nn

from pytracking_tpu_torch.ops.filter import apply_filter


class LinearFilter(nn.Module):
    def __init__(self, filter_initializer: nn.Module, filter_optimizer: nn.Module,
                 feature_extractor: nn.Module):
        super().__init__()
        self.filter_initializer = filter_initializer
        self.filter_optimizer = filter_optimizer
        self.feature_extractor = feature_extractor

    def extract_classification_feat(self, feat: torch.Tensor) -> torch.Tensor:
        """Backbone feature -> classification feature, for (B, C, H, W) or
        (N, S, C, H, W) inputs."""
        if feat.dim() == 5:
            out = self.feature_extractor(feat.flatten(0, 1))
            return out.reshape(feat.shape[:2] + out.shape[1:])
        return self.feature_extractor(feat)

    def get_filter(self, feat: torch.Tensor, bb: torch.Tensor, num_iter=None,
                   sample_weight=None, **opt_kwargs) -> torch.Tensor:
        """feat (N, S, C, H, W), bb (N, S, 4) -> the optimised filter
        (S, 1, C, fs, fs). Further keyword arguments (the hinge optimiser's
        `train_label`) go to the optimiser."""
        return self.filter_optimizer(self.filter_initializer(feat, bb), feat, bb,
                                     sample_weight=sample_weight, num_iter=num_iter,
                                     **opt_kwargs)

    def classify(self, weights: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """Scores of feat (S, C, H, W) -> (S, 1, Ho, Wo), or (N, S, C, H, W)
        -> (N, S, 1, Ho, Wo), with weights (S, 1, C, fs, fs)."""
        return apply_filter(feat, weights)
