"""ATOM default parameters (counterpart of
pytracking_tpu/parameter/atom/default.py).

No ATOM checkpoint is in the repository, so the weights (ResNet-18 and the
IoU-Net) are drawn from a seeded torch.Generator; the classifier is learned
online from the first frame. The tracker runs in IEEE float32.
"""

import torch

from pytracking_tpu_torch.models.tracking.atomnet import atom_resnet18
from pytracking_tpu_torch.trackers.atom import ATOMParams
from pytracking_tpu_torch.trackers.base import TrackerSpec


def params() -> ATOMParams:
    return ATOMParams()


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    return build_spec(params(), device, seed)


def build_spec(p: ATOMParams, device, seed: int) -> TrackerSpec:
    """`p` with ATOM's ResNet-18 net drawn from `seed`."""
    return TrackerSpec(params=p, net=atom_resnet18(
        generator=torch.Generator().manual_seed(seed), device=device))
