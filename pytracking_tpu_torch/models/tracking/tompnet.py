"""ToMP network: a ResNet backbone and the transformer head (counterpart of
pytracking_tpu/models/tracking/tompnet.py: `ToMPnet`, `tompnet50`,
`tompnet101`).

Feature maps are NCHW; a frame stack is (Nf, Ns, C, H, W). Scores are
(Nf, Ns, H, W) and dense boxes (Nf, Ns, 4, H, W).

ToMP's head dim is 512 / 8 = 64, so the transformer's attention is the
plain matmul + softmax (the fused kernel is built for the TaMOs encoder's
32), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.classifier.features import ResidualBottleneck
from pytracking_tpu_torch.models.tracking.tamosnet import backbone_bn_eval, init_weights
from pytracking_tpu_torch.models.transformer.filter_predictor import FilterPredictor
from pytracking_tpu_torch.models.transformer.heads import (DenseBoxRegressor, Head,
                                                           LinearFilterClassifier)
from pytracking_tpu_torch.models.transformer.transformer import Transformer
from pytracking_tpu_torch.utils.device import ieee_float32, resolve_device


class ToMPnet(nn.Module):
    """In train mode (`net.train()`) the head trains: the box encoder's
    BatchNorms on the batch's statistics, the transformer's dropout drawn
    from the `generator` given to `forward`; with `freeze_backbone_bn` the
    backbone's BatchNorms stay in eval mode."""

    def __init__(self, feature_extractor: nn.Module, head: Head, head_layer: str = "layer3",
                 freeze_backbone_bn: bool = False):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.head = head
        self.head_layer = head_layer
        self.freeze_backbone_bn = freeze_backbone_bn

    def train(self, mode: bool = True):
        super().train(mode)
        backbone_bn_eval(self, mode)
        return self

    def extract_backbone(self, im: torch.Tensor) -> Dict[str, torch.Tensor]:
        """im (N, 3, H, W), 0-255."""
        return self.feature_extractor(backbones.normalize_image(im))

    def get_backbone_head_feat(self, backbone_feat: Dict[str, torch.Tensor]) -> torch.Tensor:
        return backbone_feat[self.head_layer]

    def extract_head_feat(self, backbone_feat: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, C, H, W) backbone feature -> (B, C', h, w) head feature."""
        return self.head.extract_head_feat(self.get_backbone_head_feat(backbone_feat)[None])[0]

    def head_get_filters_parallel(self, train_feat, test_feat, train_label, train_ltrb,
                                  cls_frame_mask=None, bbreg_frame_mask=None):
        return self.head.get_filter_and_features_in_parallel(
            train_feat, test_feat, train_label, train_ltrb, cls_frame_mask, bbreg_frame_mask)

    def head_classify(self, feat: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
        return self.head.run_classifier(feat, filt)

    def head_bbreg(self, feat: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
        return self.head.run_bbreg(feat, filt)

    @ieee_float32()
    def forward(self, train_imgs, test_imgs, train_label, train_ltrb, generator=None):
        """train_imgs (Ntr, Ns, 3, H, W); test_imgs (Nte, Ns, 3, H, W);
        train_label (Ntr, Ns, h, w); train_ltrb (Ntr, Ns, h, w, 4). Returns
        (test scores (Nte, Ns, h, w), box predictions (Nte, Ns, 4, h, w)).
        `generator` draws the dropout masks in train mode."""
        tr = self.get_backbone_head_feat(self.extract_backbone(train_imgs.flatten(0, 1)))
        te = self.get_backbone_head_feat(self.extract_backbone(test_imgs.flatten(0, 1)))
        tr = tr.reshape(train_imgs.shape[:2] + tr.shape[1:])
        te = te.reshape(test_imgs.shape[:2] + te.shape[1:])
        return self.head(tr, te, train_label, train_ltrb, generator)


def _tompnet(backbone: nn.Module, in_dim: int, filter_size: int, head_layer: str,
             out_feature_dim: int, nhead: int, num_encoder_layers: int,
             num_decoder_layers: int, dim_feedforward: int, feature_sz: int,
             use_test_frame_encoding: bool, transformer_dtype,
             freeze_backbone_bn: bool) -> ToMPnet:
    norm_scale = math.sqrt(1.0 / (out_feature_dim * filter_size * filter_size))
    head_fe = ResidualBottleneck(in_dim=in_dim, out_dim=out_feature_dim, norm_scale=norm_scale)
    transformer = Transformer(d_model=out_feature_dim, nhead=nhead,
                              num_encoder_layers=num_encoder_layers,
                              num_decoder_layers=num_decoder_layers,
                              dim_feedforward=dim_feedforward, dtype=transformer_dtype)
    fp = FilterPredictor(transformer, feature_sz=feature_sz,
                         use_test_frame_encoding=use_test_frame_encoding)
    head = Head(filter_predictor=fp, feature_extractor=head_fe,
                classifier=LinearFilterClassifier(out_feature_dim),
                bb_regressor=DenseBoxRegressor(out_feature_dim))
    return ToMPnet(feature_extractor=backbone, head=head, head_layer=head_layer,
                   freeze_backbone_bn=freeze_backbone_bn)


def tompnet50(filter_size: int = 4, head_layer: str = "layer3", out_feature_dim: int = 512,
              nhead: int = 8, num_encoder_layers: int = 6, num_decoder_layers: int = 6,
              dim_feedforward: int = 2048, feature_sz: int = 18,
              use_test_frame_encoding: bool = True,
              backbone_dtype: Optional[torch.dtype] = None,
              transformer_dtype: Optional[torch.dtype] = None,
              freeze_backbone_bn: bool = False,
              generator: Optional[torch.Generator] = None, device="cuda") -> ToMPnet:
    """ToMP-50 on `device`, weights drawn from `generator` (seed 0 when none
    is given), in eval mode. `backbone_dtype` / `transformer_dtype` bfloat16
    run the ResNet's convolutions / the transformer's matmuls in bf16
    (float32 softmax, LayerNorm and residuals)."""
    device = resolve_device(device)
    backbone = backbones.resnet50(output_layers=(head_layer,), dtype=backbone_dtype)
    net = _tompnet(backbone, 1024, filter_size, head_layer, out_feature_dim, nhead,
                   num_encoder_layers, num_decoder_layers, dim_feedforward, feature_sz,
                   use_test_frame_encoding, transformer_dtype, freeze_backbone_bn)
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()


def tompnet101(filter_size: int = 4, head_layer: str = "layer3", out_feature_dim: int = 512,
               nhead: int = 8, num_encoder_layers: int = 6, num_decoder_layers: int = 6,
               dim_feedforward: int = 2048, feature_sz: int = 18,
               backbone_dtype: Optional[torch.dtype] = None,
               transformer_dtype: Optional[torch.dtype] = None,
               freeze_backbone_bn: bool = False,
               generator: Optional[torch.Generator] = None, device="cuda") -> ToMPnet:
    """ToMP-101: ToMP-50 with a ResNet-101 backbone."""
    device = resolve_device(device)
    backbone = backbones.resnet101(output_layers=(head_layer,), dtype=backbone_dtype)
    net = _tompnet(backbone, 1024, filter_size, head_layer, out_feature_dim, nhead,
                   num_encoder_layers, num_decoder_layers, dim_feedforward, feature_sz,
                   True, transformer_dtype, freeze_backbone_bn)
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()
