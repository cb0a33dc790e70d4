"""DiMP-50 VOT2019 parameters (counterpart of
pytracking_tpu/parameter/dimp/dimp50_vot19.py): VOT2018's with a 256x256
sample, memory 100, fewer augmentations and 3 box-refinement steps."""

import dataclasses
from typing import Optional

import torch

from pytracking_tpu_torch.parameter.dimp import dimp50, dimp50_vot18
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.dimp import DiMPParams

precision_kwargs = dimp50.precision_kwargs


def params() -> DiMPParams:
    return dataclasses.replace(
        dimp50_vot18.params(), image_sample_size=16 * 16, search_area_scale=4.5,
        sample_memory_size=100, net_opt_iter=15, net_opt_update_iter=2, net_opt_hn_iter=2,
        augmentation=(("fliplr", True),
                      ("rotate", (-5, 10, -30, 60)),
                      ("blur", ((2, 0.2), (1, 3))),
                      ("relativeshift", ((0.6, 0.6), (-0.6, -0.6))),
                      ("dropout", (3, 0.2))),
        augmentation_expansion_factor=1.4, box_refinement_iter=3)


def parameters(device="cuda", seed: int = 0, dtype: torch.dtype = torch.float32,
               backbone_dtype: Optional[torch.dtype] = None) -> TrackerSpec:
    """DiMP-50's net with its precision options (`dimp50.parameters`)."""
    return TrackerSpec(params=params(),
                       net=dimp50.build_net(device, seed, dtype, backbone_dtype))
