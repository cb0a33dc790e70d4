"""The DiMP network: backbone, meta-learned discriminative classifier and
IoU-Net (counterpart of pytracking_tpu/models/tracking/dimpnet.py:
`DiMPnet`, `dimpnet50`).

The tracker calls the parts one by one: `extract_backbone`,
`extract_classification_feat`, `classifier.get_filter` / `classify` /
`filter_optimizer`, and the `bb_regressor` methods on
`get_backbone_bbreg_feat`. Images are (B, 3, H, W) in 0-255.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.bbreg.iou_net import AtomIoUNet
from pytracking_tpu_torch.models.classifier.features import ResidualBottleneck
from pytracking_tpu_torch.models.classifier.initializer import FilterInitializerLinear
from pytracking_tpu_torch.models.classifier.linear_filter import LinearFilter
from pytracking_tpu_torch.models.classifier.optimizer import DiMPSteepestDescentGN
from pytracking_tpu_torch.models.layers.blocks import BatchNorm, trunc_normal_fan_in
from pytracking_tpu_torch.utils.device import resolve_device


class DiMPnet(nn.Module):
    """Classification on layer3, IoU-Net on layer2 and layer3."""

    def __init__(self, feature_extractor: nn.Module, classifier: LinearFilter,
                 bb_regressor: AtomIoUNet):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.classifier = classifier
        self.bb_regressor = bb_regressor

    def extract_backbone(self, im: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.feature_extractor(backbones.normalize_image(im))

    def extract_classification_feat(self, backbone_feat: Dict[str, torch.Tensor]
                                    ) -> torch.Tensor:
        return self.classifier.extract_classification_feat(backbone_feat["layer3"])

    def get_backbone_bbreg_feat(self, backbone_feat: Dict[str, torch.Tensor]):
        return [backbone_feat["layer2"], backbone_feat["layer3"]]


@torch.no_grad()
def init_weights(net: DiMPnet, generator: torch.Generator) -> DiMPnet:
    """Random weights drawn from `generator` with the JAX package's
    initialisers: lecun-normal backbone convolutions, he-normal for every
    other convolution and dense kernel, zero biases, identity BatchNorm.
    The optimiser's parameters keep their structured initial values."""
    for name, m in net.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            trunc_normal_fan_in(m.weight, 1.0 if name.startswith("feature_extractor.") else 2.0,
                                generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return net


def dimpnet50(generator: Optional[torch.Generator] = None, device="cuda") -> DiMPnet:
    """DiMP-50 on `device`, weights drawn from `generator` (seed 0 when
    none is given): ResNet-50 layer2/layer3, a 3x3 conv 1024 -> 512 with
    InstanceL2Norm as the classification feature, a 4x4 filter and its
    optimiser (5 iterations by default, step 0.9, regulariser 0.1, 100
    distance bins of 0.1 cell), IoU-Net on (512, 1024) channels with
    256-wide heads."""
    device = resolve_device(device)
    filter_size, out_dim = 4, 512
    clf_fe = ResidualBottleneck(in_dim=1024, out_dim=out_dim,
                                norm_scale=math.sqrt(1.0 / (out_dim * filter_size * filter_size)))
    optimizer = DiMPSteepestDescentGN(num_iter=5, feat_stride=16, init_step_length=0.9,
                                      init_filter_reg=0.1, init_gauss_sigma=0.9,
                                      num_dist_bins=100, bin_displacement=0.1,
                                      mask_init_factor=3.0)
    classifier = LinearFilter(FilterInitializerLinear(filter_size=filter_size,
                                                      feature_dim=out_dim),
                              optimizer, clf_fe)
    net = DiMPnet(backbones.resnet50(output_layers=("layer2", "layer3")), classifier,
                  AtomIoUNet(input_dim=(512, 1024), pred_input_dim=(256, 256),
                             pred_inter_dim=(256, 256)))
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()
