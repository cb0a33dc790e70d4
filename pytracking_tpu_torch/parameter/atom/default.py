"""ATOM default parameters (counterpart of
pytracking_tpu/parameter/atom/default.py).

The net (ResNet-18 and the IoU-Net) is the network file `atom_default` when
it exists; else, as no ATOM checkpoint is in the repository, its weights are
drawn from a seeded torch.Generator. The classifier is learned
online from the first frame. The tracker runs in IEEE float32.
"""

import torch

from pytracking_tpu_torch.models.tracking.atomnet import atom_resnet18
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.atom import ATOMParams
from pytracking_tpu_torch.trackers.base import TrackerSpec


def params() -> ATOMParams:
    return ATOMParams()


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    return build_spec(params(), device, seed)


def build_spec(p: ATOMParams, device, seed: int, network: str = "atom_default") -> TrackerSpec:
    """`p` with ATOM's ResNet-18 net: the network file `network` when it
    exists, else drawn from `seed`."""
    return TrackerSpec(params=p, net=load_or_seeded(network, lambda: atom_resnet18(
        generator=torch.Generator().manual_seed(seed), device=device), device))
