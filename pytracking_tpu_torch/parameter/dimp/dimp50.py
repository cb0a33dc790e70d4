"""DiMP-50 parameters (counterpart of pytracking_tpu/parameter/dimp/dimp50.py).

No DiMP checkpoint is in the repository, so the weights of every DiMP
parameter module are drawn from a seeded torch.Generator (the
meta-optimiser's parameters start at their structured values). The trackers
run in float32; their entry points pin IEEE float32 (no TF32).
"""

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.dimp import DiMPParams


def params() -> DiMPParams:
    return DiMPParams()                    # its defaults are DiMP-50's


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = dimpnet50(generator=torch.Generator().manual_seed(seed), device=device)
    return TrackerSpec(params=params(), net=net)
