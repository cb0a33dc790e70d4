"""PrDiMP-18 parameters (counterpart of pytracking_tpu/parameter/dimp/prdimp18.py):
PrDiMP-50's settings with the ResNet-18 KL/Newton net."""

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import klcedimpnet18
from pytracking_tpu_torch.parameter.dimp.prdimp50 import params  # noqa: F401
from pytracking_tpu_torch.trackers.base import TrackerSpec


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = klcedimpnet18(generator=torch.Generator().manual_seed(seed), device=device)
    return TrackerSpec(params=params(), net=net)
