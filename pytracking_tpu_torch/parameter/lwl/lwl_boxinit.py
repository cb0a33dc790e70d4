"""LWL box-init parameters (counterpart of
pytracking_tpu/parameter/lwl/lwl_boxinit.py): LWL's tracker with the
box-initialised net, so that tracking can start from a box alone: the
network file `lwl_boxinit` when it exists, else weights from a seeded
torch.Generator; `weights_bf16` as in `lwl_ytvos`."""

import torch

from pytracking_tpu_torch.models.lwl.lwl_net import steepest_descent_resnet50_boxinit
from pytracking_tpu_torch.parameter import precision
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.lwl import LWLParams
from pytracking_tpu_torch.utils.loading import round_to_bf16_

precision_kwargs = precision.weights_only


def params() -> LWLParams:
    return LWLParams()


def parameters(device="cuda", seed: int = 0, weights_bf16: bool = False) -> TrackerSpec:
    net = load_or_seeded("lwl_boxinit", lambda: steepest_descent_resnet50_boxinit(
        generator=torch.Generator().manual_seed(seed), device=device), device)
    if weights_bf16:
        round_to_bf16_(net)
    return TrackerSpec(params=params(), net=net)
