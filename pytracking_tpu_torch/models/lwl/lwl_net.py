"""The LWL network: backbone, few-shot target model, label encoder and
segmentation decoder (counterpart of pytracking_tpu/models/lwl/lwl_net.py:
`LWTLNet`, `steepest_descent_resnet50`, `LWTLBoxNet`,
`steepest_descent_resnet50_boxinit`; the tracking-time methods and the
training forwards `LWTLNet.forward` and `LWTLBoxNet.box_forward`).

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

    def _frames_features(self, imgs: torch.Tensor):
        """Frames (N, Ns, 3, H, W) -> (backbone features by layer, each (N,
        Ns, C, h, w); target-model features (N, Ns, C, h, w)): one backbone
        call, so one BatchNorm batch in train mode."""
        N, Ns = imgs.shape[:2]
        bb = self.extract_backbone(imgs.flatten(0, 1))
        tm = self.extract_target_model_features(bb)
        return ({k: v.reshape((N, Ns) + v.shape[1:]) for k, v in bb.items()},
                tm.reshape((N, Ns) + tm.shape[1:]))

    def forward(self, train_imgs: torch.Tensor, test_imgs: torch.Tensor,
                train_masks: torch.Tensor, num_refinement_iter: int = 2) -> torch.Tensor:
        """The training forward: the target model learnt on the train
        frames, then the test frames in order, each one's mask predicted and,
        with `num_refinement_iter` > 0, encoded from its (detached)
        probabilities and added to the learner's memory, which refines the
        model by that many steps before the next frame. The memory has Ntr +
        Nte slots throughout, those past the current frame with zero weight.
        Train and test frames go through the backbone in separate calls (two
        BatchNorm batches in train mode), the test frames through the
        decoder one at a time. train_imgs (Ntr, Ns, 3, H, W), test_imgs
        (Nte, Ns, 3, H, W) in 0-255, train_masks (Ntr, Ns, H, W). Returns mask
        logits (Nte, Ns, H, W)."""
        Nte = test_imgs.shape[0]
        image_size = tuple(train_imgs.shape[-2:])
        _, tr_tm = self._frames_features(train_imgs)
        te_bb, te_tm = self._frames_features(test_imgs)
        label, sw = self.label_encoder(train_masks, tr_tm)
        filt = self.target_model.get_filter(tr_tm, label, sw)

        mem = {"feat": [tr_tm], "label": [label], "sw": [sw]}
        masks = []
        for i in range(Nte):
            feat_i = te_tm[i:i + 1]
            enc = self.target_model.apply_target_model(filt, feat_i)
            mask = self._decode(enc, {k: v[i] for k, v in te_bb.items()}, image_size)
            masks.append(mask)
            if i < Nte - 1 and num_refinement_iter > 0:
                new_label, new_sw = self.label_encoder(torch.sigmoid(mask.detach())[None],
                                                       feat_i)
                for key, x in (("feat", feat_i), ("label", new_label), ("sw", new_sw)):
                    mem[key].append(x)
                full = {k: torch.cat(v + [v[0].new_zeros((Nte - i - 1,) + v[0].shape[1:])])
                        for k, v in mem.items()}
                filt = self.tm_update_filter(filt, full["feat"], full["label"], full["sw"],
                                             num_iter=num_refinement_iter)
        return torch.stack(masks)


class LWTLBoxNet(LWTLNet):
    """LWL with a box label encoder, so that tracking can start from a box:
    the encoded box is decoded into the first frame's mask."""

    def __init__(self, *args, box_label_encoder: nn.Module, **kwargs):
        super().__init__(*args, **kwargs)
        self.box_label_encoder = box_label_encoder

    def encode_box(self, bb, feat_tm, im_sz):
        """bb (Nf, Ns, 4); feat_tm (Nf, Ns, C, h, w) -> (label, sample weights)."""
        return self.box_label_encoder(bb, feat_tm, im_sz)

    def box_forward(self, train_imgs: torch.Tensor, train_bb: torch.Tensor) -> torch.Tensor:
        """The box-init training forward: the train frames' boxes encoded
        and decoded into masks of the same frames. train_imgs (Ntr, Ns, 3, H,
        W) in 0-255, train_bb (Ntr, Ns, 4) in crop coordinates. Returns mask
        logits (Ntr, Ns, H, W)."""
        Ntr, Ns = train_imgs.shape[:2]
        image_size = tuple(train_imgs.shape[-2:])
        bb_feat, feat_tm = self._frames_features(train_imgs)
        label, _ = self.encode_box(train_bb, feat_tm, image_size)
        mask = self._decode(label, {k: v.flatten(0, 1) for k, v in bb_feat.items()},
                            image_size)
        return mask.reshape((Ntr, Ns) + mask.shape[1:])

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
