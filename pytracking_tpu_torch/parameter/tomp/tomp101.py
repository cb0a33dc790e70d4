"""ToMP-101 parameters (counterpart of pytracking_tpu/parameter/tomp/tomp101.py):
ToMP-50's, with the ResNet-101 net."""

from typing import Optional

import torch

from pytracking_tpu_torch.models.tracking.tompnet import tompnet101
from pytracking_tpu_torch.parameter.tomp import tomp50
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.tomp import ToMPParams


def params() -> ToMPParams:
    return ToMPParams()


def parameters(device="cuda", dtype: torch.dtype = torch.float32, seed: int = 0,
               backbone_dtype: Optional[torch.dtype] = None) -> TrackerSpec:
    return tomp50.build_spec(tompnet101, params(), device, dtype, seed, backbone_dtype)
