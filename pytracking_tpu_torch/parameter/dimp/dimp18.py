"""DiMP-18 parameters (counterpart of pytracking_tpu/parameter/dimp/dimp18.py):
DiMP-50's settings with the ResNet-18 net."""

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet18
from pytracking_tpu_torch.parameter.dimp.dimp50 import params  # noqa: F401
from pytracking_tpu_torch.trackers.base import TrackerSpec


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = dimpnet18(generator=torch.Generator().manual_seed(seed), device=device)
    return TrackerSpec(params=params(), net=net)
