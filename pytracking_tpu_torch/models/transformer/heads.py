"""Transformer heads of ToMP and TaMOs (counterpart of
pytracking_tpu/models/transformer/heads.py: `LinearFilterClassifier`,
`DenseBoxRegressor`, `Head`).

feat (Nf, Ns, C, H, W); filters (Ns, K, C), one per object. The K objects are
folded into the batch of one convolution stack instead of a loop over K.
ToMP's `Head` predicts one filter per sequence, (Ns, C): K = 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.ops.filter import apply_filter

GN_EPS = 1e-6          # flax GroupNorm's default


def _apply_filters(feat: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """(Nf, Ns, C, H, W) x (Ns, K, C) 1x1 filters -> (Nf*Ns, K, H, W)."""
    Nf, Ns, C, H, W = feat.shape
    w = filters.repeat(Nf, 1, 1)[..., None, None]
    return apply_filter(feat.reshape(Nf * Ns, C, H, W), w)


class LinearFilterClassifier(nn.Module):
    """Project each object's filter with a linear layer, then correlate."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.linear = nn.Linear(num_channels, num_channels)

    def forward(self, feat: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
        """-> scores (Nf, Ns, K, H, W)."""
        Nf, Ns, C, H, W = feat.shape
        return _apply_filters(feat, self.linear(filters)).reshape(Nf, Ns, -1, H, W)


class DenseBoxRegressor(nn.Module):
    """Filter attention over the features, a 4-layer conv/GroupNorm tower and
    exp(LTRB) dense boxes."""

    def __init__(self, num_channels: int):
        super().__init__()
        c = num_channels
        self.linear = nn.Linear(c, c)
        for i in range(4):
            self.add_module(f"tower{i}_conv", nn.Conv2d(c, c, 3, padding=1))
            self.add_module(f"tower{i}_gn", nn.GroupNorm(1, c, eps=GN_EPS))
        self.bbreg_layer = nn.Conv2d(c, 4, 3, padding=1)

    def forward(self, feat: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
        """-> ltrb (Nf, Ns, K, 4, H, W)."""
        Nf, Ns, C, H, W = feat.shape
        K = filters.shape[1]
        attention = _apply_filters(feat, self.linear(filters))       # (N, K, H, W)
        x = (attention[:, :, None] * feat.reshape(Nf * Ns, 1, C, H, W))
        x = x.reshape(Nf * Ns * K, C, H, W)
        for i in range(4):
            x = getattr(self, f"tower{i}_conv")(x)
            x = F.relu(getattr(self, f"tower{i}_gn")(x))
        return torch.exp(self.bbreg_layer(x)).reshape(Nf, Ns, K, 4, H, W)


class Head(nn.Module):
    """ToMP's head: the head feature block, the filter predictor, the
    classifier and the box regressor. Scores are (Nf, Ns, H, W), dense boxes
    (Nf, Ns, 4, H, W)."""

    def __init__(self, filter_predictor: nn.Module, feature_extractor: nn.Module,
                 classifier: LinearFilterClassifier, bb_regressor: DenseBoxRegressor):
        super().__init__()
        self.filter_predictor = filter_predictor
        self.feature_extractor = feature_extractor
        self.classifier = classifier
        self.bb_regressor = bb_regressor

    def extract_head_feat(self, feat: torch.Tensor) -> torch.Tensor:
        """Backbone feature (Nf, Ns, C, H, W) -> head feature."""
        out = self.feature_extractor(feat.flatten(0, 1))
        return out.reshape(feat.shape[:2] + out.shape[1:])

    def get_filter_and_features(self, train_feat, test_feat, train_label, train_ltrb,
                                generator=None):
        weights, test_feat_enc = self.filter_predictor(train_feat, test_feat, train_label,
                                                       train_ltrb, generator)
        return weights, weights, test_feat_enc

    def get_filter_and_features_in_parallel(self, train_feat, test_feat, train_label,
                                            train_ltrb, cls_frame_mask=None,
                                            bbreg_frame_mask=None):
        return self.filter_predictor.predict_cls_bbreg_filters_parallel(
            train_feat, test_feat, train_label, train_ltrb, cls_frame_mask,
            bbreg_frame_mask)

    def run_classifier(self, feat: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
        return self.classifier(feat, filt[:, None])[:, :, 0]

    def run_bbreg(self, feat: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
        return self.bb_regressor(feat, filt[:, None])[:, :, 0]

    def forward(self, train_feat, test_feat, train_bb_label, train_ltrb, generator=None):
        train_feat = self.extract_head_feat(train_feat)
        test_feat = self.extract_head_feat(test_feat)
        cls_filter, breg_filter, test_feat_enc = self.get_filter_and_features(
            train_feat, test_feat, train_bb_label, train_ltrb, generator)
        return (self.run_classifier(test_feat_enc, cls_filter),
                self.run_bbreg(test_feat_enc, breg_filter))
