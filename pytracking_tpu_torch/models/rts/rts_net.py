"""The RTS network: LWL's mask branch fused with a DiMP-style instance
classifier (counterpart of pytracking_tpu/models/rts/rts_net.py:
`ResidualDS16SWClf`, `LearnersFusion`, `RTSNet`'s tracking-time methods,
`rts50`).

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
from pytracking_tpu_torch.models.layers.blocks import ConvBlock
from pytracking_tpu_torch.models.lwl.decoder import _interp
from pytracking_tpu_torch.models.lwl.label_encoder import SegBasicBlock, _heads
from pytracking_tpu_torch.models.lwl.lwl_net import LWTLNet, _lwl_parts, init_weights
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
