"""PrDiMP-50 parameters (counterpart of pytracking_tpu/parameter/dimp/prdimp50.py):
the KL/Newton net, softmax scores, 352x352 'inside_major' samples and box
refinement in the relative space."""

import dataclasses

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import klcedimpnet50
from pytracking_tpu_torch.parameter.dimp import dimp50
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.dimp import DiMPParams


def params() -> DiMPParams:
    return dataclasses.replace(
        dimp50.params(), image_sample_size=22 * 16, search_area_scale=6.0,
        border_mode="inside_major", patch_max_scale_change=1.5, score_preprocess="softmax",
        target_not_found_threshold=0.04, box_refinement_space="relative",
        box_refinement_iter=10, box_refinement_step_length=2.5e-3)


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = klcedimpnet50(generator=torch.Generator().manual_seed(seed), device=device)
    return TrackerSpec(params=params(), net=net)
