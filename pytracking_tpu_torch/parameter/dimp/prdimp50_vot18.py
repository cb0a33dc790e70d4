"""PrDiMP-50 VOT2018 parameters (counterpart of
pytracking_tpu/parameter/dimp/prdimp50_vot18.py): PrDiMP-50 with VOT-style
windowing and thresholds."""

import dataclasses

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import klcedimpnet50
from pytracking_tpu_torch.parameter.dimp import prdimp50
from pytracking_tpu_torch.parameter.dimp.dimp50_vot18 import VOT18
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.dimp import DiMPParams


def params() -> DiMPParams:
    return dataclasses.replace(prdimp50.params(), **VOT18)


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = klcedimpnet50(generator=torch.Generator().manual_seed(seed), device=device)
    return TrackerSpec(params=params(), net=net)
