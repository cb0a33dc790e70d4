"""ECO on MobileNetV3-Large (counterpart of
pytracking_tpu/parameter/eco/mobile3.py): 'init_conv' (stride 2, no
pooling) and 'layer5' (stride 16), power-2 normalised. Weights drawn from
a seeded torch.Generator."""

import torch

from pytracking_tpu_torch.models.backbones.mobilenetv3 import mobilenet3
from pytracking_tpu_torch.parameter.eco.default import eco_backbone
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.eco import ECOParams


def params() -> ECOParams:
    return ECOParams(feature_blocks=(("init_conv", 1), ("layer5", 1)),
                     blocks=((2, 16, 1 / 16, 0.4, 10e-3), (16, 64, 1 / 4, 0.6, 50e-3)))


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = eco_backbone(mobilenet3(("init_conv", "layer5")), torch.Generator().manual_seed(seed),
                       device)
    return TrackerSpec(params=params(), net=net)
