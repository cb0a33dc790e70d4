"""DiMP-18 parameters (counterpart of pytracking_tpu/parameter/dimp/dimp18.py):
DiMP-50's settings with the ResNet-18 net (the network file `dimp18` when it
exists, else seeded)."""

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet18
from pytracking_tpu_torch.parameter.dimp.dimp50 import params  # noqa: F401
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    return TrackerSpec(params=params(), net=build_net(device, seed))


def build_net(device, seed: int):
    """DiMP-18's net (also for its VOT set)."""
    return load_or_seeded("dimp18", lambda: dimpnet18(
        generator=torch.Generator().manual_seed(seed), device=device), device)
