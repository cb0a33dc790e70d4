"""SuperDiMP parameters (counterpart of pytracking_tpu/parameter/dimp/super_dimp.py):
DiMP-50's net at PrDiMP's operating point: 352x352 'inside_major' samples
with a scale change of at most 1.5, and 10 box-refinement steps of 2.5e-3 in
the relative box space. The net is the network file `super_dimp` when it
exists, else seeded."""

import dataclasses

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50
from pytracking_tpu_torch.parameter.dimp import dimp50
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.dimp import DiMPParams


def params() -> DiMPParams:
    return dataclasses.replace(
        dimp50.params(), image_sample_size=22 * 16, search_area_scale=6.0,
        border_mode="inside_major", patch_max_scale_change=1.5,
        box_refinement_space="relative", box_refinement_iter=10,
        box_refinement_step_length=2.5e-3)


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = load_or_seeded("super_dimp", lambda: dimpnet50(
        generator=torch.Generator().manual_seed(seed), device=device), device)
    return TrackerSpec(params=params(), net=net)
