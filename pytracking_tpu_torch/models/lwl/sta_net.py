"""STA, the box-to-mask network RTS starts from a box with (counterpart of
pytracking_tpu/models/lwl/sta_net.py: `STANet`, `sta_resnet50`).

Two few-shot target models share one feature block and one decoder: the
first is fitted to the box encoding's labels and gives a coarse mask; the
second is fitted to the coarse mask's encoding and gives the refined one.
The decoder's input is the box's label encoding concatenated with the
target model's scores. The backbone is the ImageNet ResNet-50.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.lwl.decoder import LWTLDecoder
from pytracking_tpu_torch.models.lwl.label_encoder import ResidualDS16FeatSWBox, ResidualDS16SW
from pytracking_tpu_torch.models.lwl.linear_filter import LWLLinearFilter
from pytracking_tpu_torch.models.lwl.lwl_net import (RESNET50_CHANNELS, _tm_features,
                                                     init_weights)
from pytracking_tpu_torch.utils.device import resolve_device


class STANet(nn.Module):
    """`target_model` owns the shared feature block; `target_model_segm`
    has none (the JAX module's shared block lives under `target_model`)."""

    def __init__(self, feature_extractor: nn.Module, target_model: LWLLinearFilter,
                 target_model_segm: LWLLinearFilter, decoder: LWTLDecoder,
                 label_encoder: ResidualDS16FeatSWBox, bbox_encoder: ResidualDS16FeatSWBox,
                 segm_encoder: ResidualDS16SW, target_model_input_layer: str = "layer3",
                 decoder_input_layers: Sequence[str] = ("layer4", "layer3", "layer2", "layer1")):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.target_model = target_model
        self.target_model_segm = target_model_segm
        self.decoder = decoder
        self.label_encoder = label_encoder
        self.bbox_encoder = bbox_encoder
        self.segm_encoder = segm_encoder
        self.target_model_input_layer = target_model_input_layer
        self.decoder_input_layers = tuple(decoder_input_layers)

    def extract_backbone(self, im: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.feature_extractor(backbones.normalize_image(im))

    def _decode(self, bbox_enc, scores, backbone_feat, im_sz):
        coarse = torch.cat([bbox_enc, scores], dim=2).flatten(0, 1)
        feats = {k: backbone_feat[k] for k in self.decoder_input_layers}
        mask, _ = self.decoder(coarse, feats, im_sz)
        return mask[:, 0]

    def forward(self, train_imgs: torch.Tensor, train_bbox: torch.Tensor):
        """train_imgs (Nf, Ns, 3, H, W) in 0-255, train_bbox (Nf, Ns, 4) as
        (x, y, w, h). Returns (coarse, refined) mask logits, (Nf, Ns, H, W)."""
        Nf, Ns = train_imgs.shape[:2]
        H, W = train_imgs.shape[-2:]
        bb_feat = self.extract_backbone(train_imgs.flatten(0, 1))
        feat_tm = self.target_model.extract_target_model_features(
            bb_feat[self.target_model_input_layer])
        feat_tm = feat_tm.reshape((Nf, Ns) + feat_tm.shape[1:])

        bbox_label, _ = self.label_encoder(train_bbox, feat_tm, (H, W))
        tm_label, tm_sw = self.bbox_encoder(train_bbox, feat_tm, (H, W))
        filt = self.target_model.get_filter(feat_tm, tm_label, tm_sw)
        scores = self.target_model.apply_target_model(filt, feat_tm)
        coarse = self._decode(bbox_label, scores, bb_feat, (H, W)).reshape(Nf, Ns, H, W)

        segm_label, segm_sw = self.segm_encoder(torch.sigmoid(coarse), feat_tm)
        filt_segm = self.target_model_segm.get_filter(feat_tm, segm_label, segm_sw)
        scores_segm = self.target_model_segm.apply_target_model(filt_segm, feat_tm)
        refined = self._decode(bbox_label, scores_segm, bb_feat, (H, W))
        return coarse, refined.reshape(Nf, Ns, H, W)


def sta_resnet50(filter_size: int = 3, num_filters: int = 16, optim_iter: int = 5,
                 optim_init_reg: float = 0.01, out_feature_dim: int = 512,
                 label_encoder_dims=(16, 32, 64), box_label_encoder_dims=(16, 32, 64),
                 decoder_mdim: int = 64, clf_feat_blocks: int = 1, clf_final_conv: bool = False,
                 generator: Optional[torch.Generator] = None, device="cuda") -> STANet:
    """STA on `device`, weights from `generator` (seed 0 when none is given):
    the ImageNet ResNet-50 to layer4, `clf_feat_blocks` BasicBlocks 1024 ->
    512 (and a final conv with `clf_final_conv`) with InstanceL2Norm as the
    target-model feature (by default one block: the JAX constructor's
    default layout; (0, True) is LWL's, which upstream's sta checkpoint
    ingest builds), two 3x3 target models of 16 channels, two box encoders
    (no BatchNorm but the label head's), the mask encoder and a decoder over
    32 input channels."""
    device = resolve_device(device)
    tm_feat = _tm_features(out_feature_dim, filter_size, num_blocks=clf_feat_blocks,
                           final_conv=clf_final_conv)

    def make_tm(feature_extractor):
        return LWLLinearFilter(filter_size=filter_size, num_filters=num_filters,
                               feature_dim=out_feature_dim, num_iter=optim_iter,
                               init_filter_reg=optim_init_reg,
                               feature_extractor=feature_extractor)

    box_dims = tuple(box_label_encoder_dims) + (64, num_filters)
    net = STANet(
        backbones.resnet50(output_layers=("layer1", "layer2", "layer3", "layer4")),
        make_tm(tm_feat), make_tm(None),
        LWTLDecoder(in_channels=2 * num_filters, out_channels=decoder_mdim,
                    ft_channels=RESNET50_CHANNELS, use_bn=True),
        ResidualDS16FeatSWBox(layer_dims=box_dims, feat_dim=out_feature_dim),
        ResidualDS16FeatSWBox(layer_dims=box_dims, feat_dim=out_feature_dim),
        ResidualDS16SW(layer_dims=tuple(label_encoder_dims) + (num_filters,)))
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()
