"""DiMP-50 parameters (counterpart of pytracking_tpu/parameter/dimp/dimp50.py).

The net is the network file `dimp50` (`parameter/networks.py`) when it
exists; else, as no DiMP checkpoint is in the repository, its weights are
drawn from a seeded torch.Generator (the meta-optimiser's parameters start
at their structured values), as in every DiMP parameter module. The trackers
run in float32; their entry points pin IEEE float32 (no TF32).
`backbone_dtype=torch.bfloat16` is the counterpart of
PYTRACKING_TPU_BF16_BACKBONE=1: the ResNet-50's convolutions compute in bf16.
`dtype=torch.bfloat16` is the counterpart of PYTRACKING_TPU_BF16=1: the bf16
backbone, and every float weight rounded through bf16 (`round_to_bf16_`, as
`maybe_bf16_variables` stores them).
"""

from typing import Optional

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50
from pytracking_tpu_torch.parameter import precision
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.dimp import DiMPParams
from pytracking_tpu_torch.utils.loading import round_to_bf16_

precision_kwargs = precision.dtype_or_backbone


def params() -> DiMPParams:
    return DiMPParams()                    # its defaults are DiMP-50's


def parameters(device="cuda", seed: int = 0, dtype: torch.dtype = torch.float32,
               backbone_dtype: Optional[torch.dtype] = None) -> TrackerSpec:
    return TrackerSpec(params=params(),
                       net=build_net(device, seed, dtype, backbone_dtype))


def build_net(device, seed: int, dtype: torch.dtype, backbone_dtype: Optional[torch.dtype]):
    """DiMP-50's net at `dtype` (also for the VOT sets, which keep DiMP-50's
    net and its precision options); bf16 rounds the loaded weights."""
    bf16 = dtype == torch.bfloat16
    backbone_dtype = torch.bfloat16 if bf16 else backbone_dtype
    net = load_or_seeded("dimp50", lambda: dimpnet50(
        generator=torch.Generator().manual_seed(seed), device=device,
        backbone_dtype=backbone_dtype), device, backbone_dtype=backbone_dtype)
    if bf16:
        round_to_bf16_(net)
    return net
