"""ECO default parameters (counterpart of
pytracking_tpu/parameter/eco/default.py): ResNet18-VGG-m1's 'vggconv1'
(pooled x2, stride 4) and 'layer3' (stride 16), power-2 normalised.

No checkpoint is in the repository, so the backbone's weights are drawn
from a seeded torch.Generator. `backbone_dtype=torch.bfloat16` is the
counterpart of PYTRACKING_TPU_BF16_BACKBONE=1 (and of PYTRACKING_TPU_BF16=1,
which for ECO means the same): the backbone's convolutions compute in bf16
and its outputs go back to float32 before the Fourier pipeline.
"""

from typing import Dict, Optional

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.backbones.vggm_resnet import resnet18_vggmconv1
from pytracking_tpu_torch.models.tracking.dimpnet import init_weights
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.eco import ECOParams
from pytracking_tpu_torch.utils.device import resolve_device


class ECOBackbone(nn.Module):
    """`extract_backbone` for ECO: the normalised image through the
    backbone, every output in float32 (the JAX module's `_ECOBackbone`)."""

    def __init__(self, feature_extractor: nn.Module):
        super().__init__()
        self.feature_extractor = feature_extractor

    def extract_backbone(self, im: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.feature_extractor(backbones.normalize_image(im))
        return {k: v.float() for k, v in out.items()}


def eco_backbone(feature_extractor: nn.Module, generator: Optional[torch.Generator] = None,
                 device="cuda") -> ECOBackbone:
    """The wrapper with weights drawn from `generator` (seed 0 when none is
    given; lecun-normal convolutions and dense layers, zero biases,
    identity BatchNorm: flax's defaults), on `device`."""
    device = resolve_device(device)
    net = ECOBackbone(feature_extractor)
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()


def params() -> ECOParams:
    return ECOParams()


def parameters(device="cuda", seed: int = 0,
               backbone_dtype: Optional[torch.dtype] = None) -> TrackerSpec:
    net = eco_backbone(resnet18_vggmconv1(("vggconv1", "layer3"), dtype=backbone_dtype),
                       torch.Generator().manual_seed(seed), device)
    return TrackerSpec(params=params(), net=net)
