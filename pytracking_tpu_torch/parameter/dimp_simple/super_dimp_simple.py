"""SuperDiMP-simple parameters (counterpart of
pytracking_tpu/parameter/dimp_simple/super_dimp_simple.py): SuperDiMP's
settings on the DiMP-50-simple net (the generic Gauss-Newton optimiser): the
network file `super_dimp_simple` when it exists, else seeded."""

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50_simple
from pytracking_tpu_torch.parameter.dimp.super_dimp import params  # noqa: F401
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = load_or_seeded("super_dimp_simple", lambda: dimpnet50_simple(
        generator=torch.Generator().manual_seed(seed), device=device), device)
    return TrackerSpec(params=params(), net=net)
