"""KYS parameters (counterpart of pytracking_tpu/parameter/kys/default.py):
DiMP-50's operating point (288x288 samples, an 18x18 motion grid, memory
50) with the scene-propagation branch. The net is the network file `kys`
when it exists; else, as no KYS checkpoint is in the repository, its
weights are drawn from a seeded torch.Generator."""

import torch

from pytracking_tpu_torch.models.tracking.kysnet import kysnet_res50
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.kys import KYSParams


def params() -> KYSParams:
    return KYSParams()                     # its defaults are the module's


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = load_or_seeded("kys", lambda: kysnet_res50(
        generator=torch.Generator().manual_seed(seed), device=device), device)
    return TrackerSpec(params=params(), net=net)
