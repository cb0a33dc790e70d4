"""The RTS network: LWL's mask branch fused with a DiMP-style instance
classifier (counterpart of pytracking_tpu/models/rts/rts_net.py:
`ResidualDS16SWClf`, `LearnersFusion`, `RTSNet`'s tracking-time methods and
training forward, `rts50`).

The classifier's score map is encoded into the mask-encoding space
(`ResidualDS16SWClf`), resized to the target model's grid and fused with
the mask encoding before the decoder.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.classifier.features import ResidualBottleneck
from pytracking_tpu_torch.models.classifier.initializer import FilterInitializerLinear
from pytracking_tpu_torch.models.classifier.linear_filter import LinearFilter
from pytracking_tpu_torch.models.classifier.residual_modules import GNSteepestDescentHinge
from pytracking_tpu_torch.models.layers.blocks import ConvBlock, eval_mode
from pytracking_tpu_torch.models.lwl.decoder import _interp
from pytracking_tpu_torch.models.lwl.label_encoder import SegBasicBlock, _heads
from pytracking_tpu_torch.models.lwl.lwl_net import LWTLNet, _lwl_parts, init_weights
from pytracking_tpu_torch.ops.dcf import gauss_2d
from pytracking_tpu_torch.utils.device import resolve_device


class ResidualDS16SWClf(nn.Module):
    """Classifier score map -> (encoding, sample weights) at the score
    map's own resolution (the stride-1 ResidualDS16SW)."""

    def __init__(self, layer_dims: Sequence[int] = (16, 32, 64, 16), use_bn: bool = True):
        super().__init__()
        d = tuple(layer_dims)
        self.conv_block = ConvBlock(1, d[0], 3, batch_norm=use_bn)
        self.res1 = SegBasicBlock(d[0], d[1], stride=1, use_bn=use_bn)
        self.res2 = SegBasicBlock(d[1], d[2], stride=1, use_bn=use_bn)
        self.label_pred, self.samp_w_pred = _heads(d[2], d[3], use_bn)

    def forward(self, score: torch.Tensor):
        """score (Nf, Ns, h, w) -> (Nf, Ns, K, h, w) twice."""
        Nf, Ns = score.shape[:2]
        x = self.conv_block(score.reshape((-1, 1) + score.shape[2:]))
        x = F.max_pool2d(x, 3, stride=1, padding=1)
        x = self.res2(self.res1(x))
        label, sw = self.label_pred(x), self.samp_w_pred(x)
        return (label.reshape((Nf, Ns) + label.shape[1:]),
                sw.reshape((Nf, Ns) + sw.shape[1:]))


class LearnersFusion(nn.Module):
    """'add' sums the two encodings; 'concat' concatenates them and projects
    back to `out_channels` with a 3x3 convolution."""

    def __init__(self, fusion_type: str = "concat", in_channels: int = 16,
                 out_channels: int = 16):
        super().__init__()
        if fusion_type not in ("add", "concat"):
            raise ValueError(f"unknown fusion type {fusion_type!r}")
        self.fusion_type = fusion_type
        if fusion_type == "concat":
            self.fusion_conv1 = nn.Conv2d(2 * in_channels, out_channels, 3, padding=1)

    def forward(self, seg_enc: torch.Tensor, clf_enc: torch.Tensor) -> torch.Tensor:
        """(N, S, K, h, w) each."""
        if self.fusion_type == "add":
            return seg_enc + clf_enc
        x = torch.cat([seg_enc, clf_enc], dim=2)
        out = self.fusion_conv1(x.flatten(0, 1))
        return out.reshape(x.shape[:2] + out.shape[1:])


class RTSNet(LWTLNet):
    """LWL's surface plus the classifier branch: `extract_classification_feat`
    (on `classification_layer`), `clf_get_filter`, `clf_classify`, and the
    fused decode `segment_target_with_clf`."""

    def __init__(self, feature_extractor, target_model, decoder, label_encoder,
                 classifier: LinearFilter, clf_encoder: ResidualDS16SWClf,
                 fusion_module: LearnersFusion, classification_layer: str = "layer3",
                 **kwargs):
        super().__init__(feature_extractor, target_model, decoder, label_encoder, **kwargs)
        self.classifier = classifier
        self.clf_encoder = clf_encoder
        self.fusion_module = fusion_module
        self.classification_layer = classification_layer

    def extract_classification_feat(self, backbone_feat: Dict[str, torch.Tensor]):
        return self.classifier.extract_classification_feat(
            backbone_feat[self.classification_layer])

    def clf_get_filter(self, feat, bb, train_label, num_iter=None, sample_weight=None):
        """The hinge optimiser fitted to the tracker's labels."""
        return self.classifier.get_filter(feat, bb, num_iter=num_iter,
                                          sample_weight=sample_weight, train_label=train_label)

    def clf_classify(self, weights, feat):
        return self.classifier.classify(weights, feat)

    def segment_target_with_clf(self, filt, test_feat_tm, backbone_feat, clf_score,
                                image_size: Tuple[int, int]):
        """test_feat_tm (1, S, C, h, w); clf_score (1, S, hs, ws). Returns
        (mask logits (S, H, W), the fused encoding (1, S, K, h, w))."""
        enc = self.target_model.apply_target_model(filt, test_feat_tm)
        clf_enc, _ = self.clf_encoder(clf_score)
        clf_enc = _interp(clf_enc.flatten(0, 1), enc.shape[-2:]).reshape(enc.shape)
        fused = self.fusion_module(enc, clf_enc)
        return self._decode(fused, backbone_feat, image_size), fused

    def forward(self, train_imgs: torch.Tensor, test_imgs: torch.Tensor,
                train_masks: torch.Tensor, train_bb: torch.Tensor,
                train_label: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training forward: the classifier fitted on the train frames
        (to `train_label`, or to `fallback_train_label`) and its scores on
        the test frames; the target model learnt on the train masks; then
        each test frame's masks decoded from the mask encoding fused with
        the encoded scores of every sequence. Train and test frames go
        through the backbone in separate calls (two BatchNorm batches in
        train mode), the test frames through the decoder one at a time; the
        score encoder's BatchNorms stay in eval mode, as the JAX package
        calls it. train_imgs (Ntr, Ns, 3, H, W), test_imgs (Nte, Ns, 3, H,
        W) in 0-255, train_masks (Ntr, Ns, H, W), train_bb (Ntr, Ns, 4).
        Returns (mask logits (Nte, Ns, H, W), classifier scores (Nte, Ns, 1,
        h', w'))."""
        image_size = tuple(train_imgs.shape[-2:])
        tr_bb, tr_tm = self._frames_features(train_imgs)
        te_bb, te_tm = self._frames_features(test_imgs)
        tr_clf = self.extract_classification_feat(tr_bb)
        te_clf = self.extract_classification_feat(te_bb)

        if train_label is None:
            train_label = fallback_train_label(
                train_bb, tuple(tr_clf.shape[-2:]), image_size,
                self.classifier.filter_initializer.filter_size)
        clf_filter = self.classifier.get_filter(tr_clf, train_bb, train_label=train_label)
        clf_scores = self.classifier.classify(clf_filter, te_clf)

        label, sw = self.label_encoder(train_masks, tr_tm)
        filt = self.target_model.get_filter(tr_tm, label, sw)
        masks = []
        for i in range(test_imgs.shape[0]):
            enc = self.target_model.apply_target_model(filt, te_tm[i:i + 1])
            with eval_mode(self.clf_encoder):
                clf_enc, _ = self.clf_encoder(clf_scores[i:i + 1, :, 0])
            clf_enc = _interp(clf_enc.flatten(0, 1), enc.shape[-2:]).reshape(enc.shape)
            fused = self.fusion_module(enc, clf_enc)
            masks.append(self._decode(fused, {k: v[i] for k, v in te_bb.items()},
                                      image_size))
        return torch.stack(masks), clf_scores


def fallback_train_label(train_bb: torch.Tensor, grid: Tuple[int, int],
                         image_size: Tuple[int, int], filter_size: int) -> torch.Tensor:
    """Gaussian train labels for the hinge optimiser where none are given:
    at each train box's centre on the classifier's (h, w) grid (stride
    image_size / grid), sigma a quarter of sqrt(h * w), end-padded by one
    cell for an even filter. train_bb (Ntr, Ns, 4) -> (Ntr, Ns, h + pad,
    w + pad)."""
    h, w = grid
    ep = (filter_size + 1) % 2
    cx, cy = (train_bb[..., :2] + train_bb[..., 2:] / 2).reshape(-1, 2).unbind(-1)
    # (y, x) on the grid, relative to its centre; sigma as a device tensor:
    # no value crosses from the host
    ctr = torch.stack([cy * (h / image_size[0]) - h / 2, cx * (w / image_size[1]) - w / 2], -1)
    sig = torch.full_like(ctr, 0.25 * math.sqrt(h * w))
    label = gauss_2d((h, w), sig, ctr, (ep, ep))
    return label.reshape(train_bb.shape[:2] + label.shape[1:])


def rts50(filter_size: int = 3, num_filters: int = 16, optim_iter: int = 5,
          optim_init_reg: float = 0.01, out_feature_dim: int = 512, clf_filter_size: int = 4,
          label_encoder_dims=(16, 32, 64), decoder_mdim: int = 64,
          clf_hinge_threshold: float = 0.05, clf_activation_leak: float = 0.1,
          clf_score_act: str = "relu", use_bn_in_label_enc: bool = False,
          fusion_type: str = "add", generator: Optional[torch.Generator] = None,
          device="cuda") -> RTSNet:
    """RTS-50 on `device`, weights from `generator` (seed 0 when none is
    given), with the rts50 recipe's defaults: LWL's mask branch on the
    maskrcnn ResNet-50, and a classifier on layer3 through a stride-2 3x3
    conv 1024 -> 512 (/32 features), a 4x4 filter from the linear
    initialiser and the hinge optimiser (labels from the tracker)."""
    device = resolve_device(device)
    tm, enc, dec = _lwl_parts(filter_size, num_filters, optim_iter, optim_init_reg,
                              out_feature_dim, label_encoder_dims, decoder_mdim,
                              use_bn_in_label_enc)
    norm_scale = math.sqrt(1.0 / (out_feature_dim * filter_size * filter_size))
    clf_fe = ResidualBottleneck(in_dim=1024, out_dim=out_feature_dim, norm_scale=norm_scale,
                                feature_dim=256, num_blocks=0, final_conv=True, final_stride=2)
    optimizer = GNSteepestDescentHinge(num_iter=optim_iter, feat_stride=16,
                                       init_filter_reg=optim_init_reg,
                                       hinge_threshold=clf_hinge_threshold,
                                       activation_leak=clf_activation_leak,
                                       score_act=clf_score_act, learn_filter_reg=False)
    classifier = LinearFilter(FilterInitializerLinear(filter_size=clf_filter_size,
                                                      feature_dim=out_feature_dim),
                              optimizer, clf_fe)
    clf_encoder = ResidualDS16SWClf(layer_dims=tuple(label_encoder_dims) + (num_filters,),
                                    use_bn=use_bn_in_label_enc)
    net = RTSNet(backbones.resnet50_mrcnn(), tm, dec, enc, classifier, clf_encoder,
                 LearnersFusion(fusion_type, num_filters, num_filters))
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()
