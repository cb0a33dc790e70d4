"""DiMP-50 VOT2019 parameters (counterpart of
pytracking_tpu/parameter/dimp/dimp50_vot19.py): VOT2018's with a 256x256
sample, memory 100, fewer augmentations and 3 box-refinement steps."""

import dataclasses

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50
from pytracking_tpu_torch.parameter.dimp import dimp50_vot18
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.dimp import DiMPParams


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


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = dimpnet50(generator=torch.Generator().manual_seed(seed), device=device)
    return TrackerSpec(params=params(), net=net)
