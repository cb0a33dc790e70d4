"""The LWL network: backbone, few-shot target model, label encoder and
segmentation decoder (counterpart of pytracking_tpu/models/lwl/lwl_net.py:
`LWTLNet`, `steepest_descent_resnet50`, `LWTLBoxNet`,
`steepest_descent_resnet50_boxinit`; the tracking-time methods).

The tracker calls the parts one by one. Images are (B, 3, H, W) in 0-255;
the S axis of the target model's (N, S, ...) tensors is the object axis of
a batched multi-object step.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.classifier.features import ResidualBasicBlock
from pytracking_tpu_torch.models.layers.blocks import BatchNorm, trunc_normal_fan_in
from pytracking_tpu_torch.models.lwl.decoder import LWTLDecoder
from pytracking_tpu_torch.models.lwl.label_encoder import ResidualDS16FeatSWBox, ResidualDS16SW
from pytracking_tpu_torch.models.lwl.linear_filter import LWLLinearFilter
from pytracking_tpu_torch.utils.device import resolve_device

RESNET50_CHANNELS = {"layer1": 256, "layer2": 512, "layer3": 1024, "layer4": 2048}


class LWTLNet(nn.Module):
    def __init__(self, feature_extractor: nn.Module, target_model: LWLLinearFilter,
                 decoder: LWTLDecoder, label_encoder: nn.Module,
                 target_model_input_layer: str = "layer3",
                 decoder_input_layers: Sequence[str] = ("layer4", "layer3", "layer2", "layer1"),
                 backbone_norm: str = "bgr255"):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.target_model = target_model
        self.decoder = decoder
        self.label_encoder = label_encoder
        self.target_model_input_layer = target_model_input_layer
        self.decoder_input_layers = tuple(decoder_input_layers)
        self.backbone_norm = backbone_norm

    def extract_backbone(self, im: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = backbones.normalize_image_bgr255(im) if self.backbone_norm == "bgr255" \
            else backbones.normalize_image(im)
        return self.feature_extractor(x)

    def extract_target_model_features(self, backbone_feat: Dict[str, torch.Tensor]):
        return self.target_model.extract_target_model_features(
            backbone_feat[self.target_model_input_layer])

    def label_encode(self, masks: torch.Tensor, feat: Optional[torch.Tensor] = None):
        """masks (Nf, Ns, H, W) -> (label, sample weights), (Nf, Ns, K, h, w)."""
        return self.label_encoder(masks, feat)

    def tm_get_filter(self, feat, label, sample_weight=None, num_iter=None):
        return self.target_model.get_filter(feat, label, sample_weight, num_iter)

    def tm_update_filter(self, filt, feat, label, sample_weight=None, num_iter=2):
        return self.target_model.update_filter(filt, feat, label, sample_weight, num_iter)

    def _decode(self, enc: torch.Tensor, backbone_feat, image_size) -> torch.Tensor:
        feats = {k: backbone_feat[k] for k in self.decoder_input_layers}
        mask, _ = self.decoder(enc.flatten(0, 1), feats, image_size)
        return mask[:, 0]

    def segment_target(self, filt: torch.Tensor, test_feat_tm: torch.Tensor,
                       backbone_feat: Dict[str, torch.Tensor], image_size: Tuple[int, int]):
        """test_feat_tm (1, S, C, h, w), filt (S, K, C, fs, fs), backbone
        features of the S crops. Returns (mask logits (S, H, W), the mask
        encoding (1, S, K, h, w))."""
        enc = self.target_model.apply_target_model(filt, test_feat_tm)
        return self._decode(enc, backbone_feat, image_size), enc


class LWTLBoxNet(LWTLNet):
    """LWL with a box label encoder, so that tracking can start from a box:
    the encoded box is decoded into the first frame's mask."""

    def __init__(self, *args, box_label_encoder: nn.Module, **kwargs):
        super().__init__(*args, **kwargs)
        self.box_label_encoder = box_label_encoder

    def encode_box(self, bb, feat_tm, im_sz):
        """bb (Nf, Ns, 4); feat_tm (Nf, Ns, C, h, w) -> (label, sample weights)."""
        return self.box_label_encoder(bb, feat_tm, im_sz)

    def segment_target_from_box(self, bb, feat_tm, backbone_feat, image_size):
        """Box -> label encoding -> decoded mask logits (S, H, W), no filter."""
        label, _ = self.encode_box(bb, feat_tm, image_size)
        return self._decode(label, backbone_feat, image_size), label


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from `generator` with the JAX package's initialisers:
    he-normal for conv blocks (`Conv_0`) and the feature blocks'
    `final_conv`, zero weights and bias one for the sample-weight heads,
    lecun-normal for every other convolution, zero biases, identity
    BatchNorm. The target models' regularisers keep their initial values."""
    for name, m in net.named_modules():
        if isinstance(m, nn.Conv2d):
            if name.endswith("samp_w_pred"):
                m.weight.zero_()
                m.bias.fill_(1.0)
                continue
            he = name.endswith((".Conv_0", "final_conv"))
            trunc_normal_fan_in(m.weight, 2.0 if he else 1.0, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return net


def _tm_features(out_feature_dim: int, filter_size: int, num_blocks: int = 0,
                 final_conv: bool = True) -> nn.Module:
    """Target-model feature block on layer3 (1024 channels) with the
    InstanceL2Norm scale of a filter_size^2 filter."""
    norm_scale = math.sqrt(1.0 / (out_feature_dim * filter_size * filter_size))
    return ResidualBasicBlock(in_dim=1024, out_dim=out_feature_dim, norm_scale=norm_scale,
                              feature_dim=1024, num_blocks=num_blocks, final_conv=final_conv)


def _lwl_parts(filter_size, num_filters, optim_iter, optim_init_reg, out_feature_dim,
               label_encoder_dims, decoder_mdim, use_bn_in_label_enc):
    target_model = LWLLinearFilter(filter_size=filter_size, num_filters=num_filters,
                                   feature_dim=out_feature_dim, num_iter=optim_iter,
                                   init_filter_reg=optim_init_reg,
                                   feature_extractor=_tm_features(out_feature_dim, filter_size))
    label_encoder = ResidualDS16SW(layer_dims=tuple(label_encoder_dims) + (num_filters,),
                                   use_bn=use_bn_in_label_enc)
    decoder = LWTLDecoder(in_channels=num_filters, out_channels=decoder_mdim,
                          ft_channels=RESNET50_CHANNELS, use_bn=True)
    return target_model, label_encoder, decoder


def steepest_descent_resnet50(filter_size: int = 3, num_filters: int = 16, optim_iter: int = 5,
                              optim_init_reg: float = 0.01, out_feature_dim: int = 512,
                              label_encoder_dims=(16, 32, 64), decoder_mdim: int = 64,
                              use_bn_in_label_enc: bool = False,
                              generator: Optional[torch.Generator] = None,
                              device="cuda") -> LWTLNet:
    """LWL on `device` with weights from `generator` (seed 0 when none is
    given): the maskrcnn ResNet-50 (BGR-255 input) to layer4, a 3x3 conv
    1024 -> 512 with InstanceL2Norm as the target-model feature, a 3x3
    filter of 16 channels, the mask label encoder and the 4-level decoder.
    The defaults are the JAX constructor's (the lwl_stage2 recipe)."""
    device = resolve_device(device)
    tm, enc, dec = _lwl_parts(filter_size, num_filters, optim_iter, optim_init_reg,
                              out_feature_dim, label_encoder_dims, decoder_mdim,
                              use_bn_in_label_enc)
    net = LWTLNet(backbones.resnet50_mrcnn(), tm, dec, enc)
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()


def steepest_descent_resnet50_boxinit(filter_size: int = 3, num_filters: int = 16,
                                      optim_iter: int = 5, optim_init_reg: float = 0.01,
                                      out_feature_dim: int = 512,
                                      label_encoder_dims=(16, 32, 64),
                                      box_label_encoder_dims=(16, 32, 64, 64),
                                      decoder_mdim: int = 64,
                                      generator: Optional[torch.Generator] = None,
                                      device="cuda") -> LWTLBoxNet:
    """`steepest_descent_resnet50` with the box label encoder (BatchNorm in
    every block), for tracking from a box."""
    device = resolve_device(device)
    tm, enc, dec = _lwl_parts(filter_size, num_filters, optim_iter, optim_init_reg,
                              out_feature_dim, label_encoder_dims, decoder_mdim, False)
    box_enc = ResidualDS16FeatSWBox(layer_dims=tuple(box_label_encoder_dims) + (num_filters,),
                                    feat_dim=out_feature_dim, use_bn=True)
    net = LWTLBoxNet(backbones.resnet50_mrcnn(), tm, dec, enc, box_label_encoder=box_enc)
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()
