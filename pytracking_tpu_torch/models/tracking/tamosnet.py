"""TaMOs network: multi-object transformer tracking with an FPN (counterpart
of pytracking_tpu/models/tracking/tamosnet.py: `FPN`, `TaMOsNet`,
`tamosnet_resnet50`, `tamosnet_swin_base`).

Feature maps are NCHW; a frame stack is (Nf, Ns, C, H, W). Scores are
(Nf, Ns, K, H, W) and dense boxes (Nf, Ns, K, 4, H, W).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.backbones.swin import WindowAttention, swin_base
from pytracking_tpu_torch.models.classifier.features import ResidualBottleneck
from pytracking_tpu_torch.models.layers.blocks import BatchNorm, trunc_normal_fan_in
from pytracking_tpu_torch.models.transformer.filter_predictor import FilterPredictor
from pytracking_tpu_torch.models.transformer.got_filter_predictor import \
    GOTFilterPredictor
from pytracking_tpu_torch.models.transformer.heads import (DenseBoxRegressor,
                                                           LinearFilterClassifier)
from pytracking_tpu_torch.models.transformer.transformer import Transformer
from pytracking_tpu_torch.utils.device import ieee_float32, resolve_device


@functools.cache
def _nearest_indices(in_size: int, out_size: int, device) -> torch.Tensor:
    """jax.image.resize 'nearest': source index floor((i + 0.5) * in / out)."""
    offsets = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * in_size / out_size
    return torch.floor(offsets).to(torch.int64)


@functools.cache
def cubic_resize_matrix(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out, in) weights of jax.image.resize(..., 'cubic') along one axis:
    Keys' cubic kernel with a = -0.5 (torch's bicubic uses a = -0.75 and
    clamps at the border), columns renormalised where the kernel leaves the
    input, zero for samples outside it, antialiased when downsampling.
    Cached per (sizes, device): callers must not modify the result."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = torch.abs(sample_f[None, :]
                  - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]) \
        / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T


class FPN(nn.Module):
    """Two-level feature pyramid: the transformer-enhanced stride-16 map is
    upsampled (nearest) and fused with the lateral stride-8 backbone layer."""

    def __init__(self, enc_dim: int, high_dim: int, output_dim: int = 256):
        super().__init__()
        self.lateral3 = nn.Conv2d(enc_dim, output_dim, 1)
        self.lateral2 = nn.Conv2d(high_dim, output_dim, 1)
        self.smooth2 = nn.Conv2d(output_dim, output_dim, 3, padding=1)
        self.smooth3 = nn.Conv2d(output_dim, output_dim, 3, padding=1)

    def forward(self, feat_enc: torch.Tensor, feat_high: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        lat3 = self.lateral3(feat_enc)
        lat2 = self.lateral2(feat_high)
        iy = _nearest_indices(lat3.shape[-2], lat2.shape[-2], lat3.device)
        ix = _nearest_indices(lat3.shape[-1], lat2.shape[-1], lat3.device)
        up3 = lat3[:, :, iy][:, :, :, ix]
        return {"feat2": self.smooth2(lat2 + up3), "feat3": self.smooth3(lat3)}


def backbone_bn_eval(net: nn.Module, mode: bool) -> None:
    """After `nn.Module.train(mode)`: with the net's `freeze_backbone_bn`,
    the backbone's BatchNorms stay in eval mode in train mode (they
    normalise with their running statistics, which do not move), as the
    JAX nets run their backbone with train=False."""
    if mode and net.freeze_backbone_bn:
        for m in net.feature_extractor.modules():
            if isinstance(m, BatchNorm):
                m.eval()


class TaMOsNet(nn.Module):
    """In train mode (`net.train()`) the head trains: the box encoder's
    BatchNorms on the batch's statistics, the transformer's dropout drawn
    from the `generator` given to `forward`; with `freeze_backbone_bn` the
    backbone's BatchNorms stay in eval mode."""

    def __init__(self, feature_extractor: nn.Module, head_feature_extractor: nn.Module,
                 filter_predictor: GOTFilterPredictor, classifier: LinearFilterClassifier,
                 bb_regressor: DenseBoxRegressor, fpn: FPN, head_layer: str = "layer3",
                 high_res_layer: str = "layer2", freeze_backbone_bn: bool = False):
        super().__init__()
        self.freeze_backbone_bn = freeze_backbone_bn
        self.feature_extractor = feature_extractor
        self.head_feature_extractor = head_feature_extractor
        self.filter_predictor = filter_predictor
        self.classifier = classifier
        self.bb_regressor = bb_regressor
        self.fpn = fpn
        self.head_layer = head_layer
        self.high_res_layer = high_res_layer

    def train(self, mode: bool = True):
        super().train(mode)
        backbone_bn_eval(self, mode)
        return self

    def extract_backbone(self, im: torch.Tensor) -> Dict[str, torch.Tensor]:
        """im (N, 3, H, W), 0-255."""
        return self.feature_extractor(backbones.normalize_image(im))

    def extract_head_feat(self, backbone_feat: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.head_feature_extractor(backbone_feat[self.head_layer])

    def predict_filters(self, train_feat, test_feat, train_label, train_ltrb=None,
                        train_frame_mask=None, generator=None):
        return self.filter_predictor.predict_filter(
            train_feat, test_feat, train_label, train_ltrb, train_frame_mask, generator)

    def predict_filters_parallel(self, train_feat, test_feat, train_label, train_ltrb,
                                 train_frame_mask, gth_frame_mask):
        return self.filter_predictor.predict_cls_bbreg_filters_parallel(
            train_feat, test_feat, train_label, train_ltrb, train_frame_mask,
            gth_frame_mask)

    def classify(self, feat: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
        return self.classifier(feat, filters)

    def classify_trafo(self, test_feat_enc, filters, out_hw):
        """Scores on the transformer's stride-16 feature, upsampled to the FPN
        high-res grid with jax.image.resize's cubic weights."""
        scores = self.classify(test_feat_enc, filters)          # (Nf, Ns, K, h, w)
        wy = cubic_resize_matrix(scores.shape[-2], out_hw[0], scores.device)
        wx = cubic_resize_matrix(scores.shape[-1], out_hw[1], scores.device)
        return torch.matmul(torch.matmul(wy, scores), wx.T)

    def run_fpn(self, test_feat_enc, backbone_feat):
        Nf, Ns = test_feat_enc.shape[:2]
        out = self.fpn(test_feat_enc.flatten(0, 1), backbone_feat[self.high_res_layer])
        return {k: v.reshape((Nf, Ns) + v.shape[1:]) for k, v in out.items()}

    def bbreg(self, feat: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
        return self.bb_regressor(feat, filters)

    @ieee_float32()
    def forward(self, train_imgs, test_imgs, train_label, train_ltrb=None, generator=None):
        """train_imgs (Ntr, Ns, 3, H, W); test_imgs (Nte, Ns, 3, H, W);
        train_label (Ntr, Ns, K, h, w); train_ltrb (Ntr, Ns, K, h, w, 4).
        Returns (scores (Nte, Ns, K, h2, w2), ltrb (Nte, Ns, K, 4, h2, w2)) on
        the high-res FPN level. `generator` draws the dropout masks in train
        mode."""
        Ntr, Ns = train_imgs.shape[:2]
        Nte = test_imgs.shape[0]
        tr = self.extract_backbone(train_imgs.flatten(0, 1))
        te = self.extract_backbone(test_imgs.flatten(0, 1))
        tr_f = self.extract_head_feat(tr)
        te_f = self.extract_head_feat(te)
        tr_f = tr_f.reshape((Ntr, Ns) + tr_f.shape[1:])
        te_f = te_f.reshape((Nte, Ns) + te_f.shape[1:])
        filters, te_enc = self.predict_filters(tr_f, te_f, train_label, train_ltrb,
                                               generator=generator)
        pyr = self.run_fpn(te_enc, te)
        return self.classify(pyr["feat2"], filters), self.bbreg(pyr["feat2"], filters)


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from `generator` with the JAX package's
    initialisers: lecun-normal convolution and dense kernels, he-normal for
    the head feature conv, orthogonal object queries (TaMOs), unit-normal
    foreground and test tokens (ToMP), a truncated normal of std 0.02 for
    Swin's relative position biases, zero biases, unit norm scales and
    identity BatchNorm statistics."""
    for name, m in net.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            trunc_normal_fan_in(m.weight, 2.0 if name.endswith("final_conv") else 1.0,
                                generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, GOTFilterPredictor):
            nn.init.orthogonal_(m.query_embed_fg, generator=generator)
        elif isinstance(m, FilterPredictor):
            nn.init.normal_(m.query_embed_fg, generator=generator)
            if m.query_embed_test is not None:
                nn.init.normal_(m.query_embed_test, generator=generator)
        if isinstance(m, WindowAttention):
            nn.init.trunc_normal_(m.rel_pos_bias, 0.0, 0.02, -0.04, 0.04, generator=generator)
    return net


def tamosnet_resnet50(filter_size: int = 1, head_layer: str = "layer3",
                      out_feature_dim: int = 256, nhead: int = 8,
                      num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                      dim_feedforward: int = 2048, feature_sz: int = 36,
                      num_tokens: int = 10, box_enc: str = "ltrb_token",
                      backbone_dtype: Optional[torch.dtype] = None,
                      transformer_dtype: Optional[torch.dtype] = None,
                      freeze_backbone_bn: bool = False,
                      generator: Optional[torch.Generator] = None,
                      device="cuda") -> TaMOsNet:
    """TaMOs-ResNet50 on `device`, weights drawn from `generator` (seed 0
    when none is given), in eval mode."""
    device = resolve_device(device)
    backbone = backbones.resnet50(output_layers=("layer2", "layer3"),
                                  dtype=backbone_dtype)
    norm_scale = math.sqrt(1.0 / (out_feature_dim * filter_size * filter_size))
    head_fe = ResidualBottleneck(in_dim=1024, out_dim=out_feature_dim,
                                 norm_scale=norm_scale)
    transformer = Transformer(d_model=out_feature_dim, nhead=nhead,
                              num_encoder_layers=num_encoder_layers,
                              num_decoder_layers=num_decoder_layers,
                              dim_feedforward=dim_feedforward, dtype=transformer_dtype)
    fp = GOTFilterPredictor(transformer, feature_sz=feature_sz, num_tokens=num_tokens,
                            box_enc=box_enc)
    net = TaMOsNet(feature_extractor=backbone, head_feature_extractor=head_fe,
                   filter_predictor=fp,
                   classifier=LinearFilterClassifier(out_feature_dim),
                   bb_regressor=DenseBoxRegressor(out_feature_dim),
                   fpn=FPN(out_feature_dim, 512, out_feature_dim), head_layer=head_layer,
                   freeze_backbone_bn=freeze_backbone_bn)
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()


def tamosnet_swin_base(filter_size: int = 1, out_feature_dim: int = 256,
                       nhead: int = 8, num_encoder_layers: int = 6,
                       num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                       feature_sz: int = 36, num_tokens: int = 10,
                       box_enc: str = "ltrb_token",
                       transformer_dtype: Optional[torch.dtype] = None,
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> TaMOsNet:
    """TaMOs with a Swin-Base backbone (float32) on `device`: the head
    feature from stage3 (512 channels), the FPN's high-res level from
    stage2 (256 channels). Weights drawn from `generator` (seed 0 when none
    is given), in eval mode. Swin has no BatchNorm to freeze."""
    device = resolve_device(device)
    norm_scale = math.sqrt(1.0 / (out_feature_dim * filter_size * filter_size))
    head_fe = ResidualBottleneck(in_dim=512, out_dim=out_feature_dim, norm_scale=norm_scale,
                                 feature_dim=128)
    transformer = Transformer(d_model=out_feature_dim, nhead=nhead,
                              num_encoder_layers=num_encoder_layers,
                              num_decoder_layers=num_decoder_layers,
                              dim_feedforward=dim_feedforward, dtype=transformer_dtype)
    fp = GOTFilterPredictor(transformer, feature_sz=feature_sz, num_tokens=num_tokens,
                            box_enc=box_enc)
    net = TaMOsNet(feature_extractor=swin_base(output_layers=("stage2", "stage3")),
                   head_feature_extractor=head_fe, filter_predictor=fp,
                   classifier=LinearFilterClassifier(out_feature_dim),
                   bb_regressor=DenseBoxRegressor(out_feature_dim),
                   fpn=FPN(out_feature_dim, 256, out_feature_dim), head_layer="stage3",
                   high_res_layer="stage2")
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()
