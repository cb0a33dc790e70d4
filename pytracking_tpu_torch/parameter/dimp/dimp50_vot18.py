"""DiMP-50 VOT2018 parameters (counterpart of
pytracking_tpu/parameter/dimp/dimp50_vot18.py): a smaller search region, a
large memory, more augmentations, the windowed output and VOT-style
thresholds."""

import dataclasses

import torch

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50
from pytracking_tpu_torch.parameter.dimp import dimp50
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.dimp import DiMPParams

VOT18 = dict(
    image_sample_size=14 * 16, search_area_scale=4.0, sample_memory_size=250,
    learning_rate=0.0075, init_samples_minimum_weight=0.0, train_skipping=10,
    window_output=True, target_not_found_threshold=0.0, hard_negative_threshold=0.45,
    perform_hn_without_windowing=True)


def params() -> DiMPParams:
    return dataclasses.replace(
        dimp50.params(), **VOT18,
        net_opt_iter=25, net_opt_update_iter=3, net_opt_hn_iter=3,
        augmentation=(("fliplr", True),
                      ("rotate", (5, -5, 10, -10, 20, -20, 30, -30, 45, -45, -60, 60)),
                      ("blur", ((2, 0.2), (0.2, 2), (3, 1), (1, 3), (2, 2))),
                      ("relativeshift", ((0.6, 0.6), (-0.6, 0.6), (0.6, -0.6), (-0.6, -0.6))),
                      ("dropout", (7, 0.2))),
        distractor_threshold=100.0, displacement_scale=0.7)


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = dimpnet50(generator=torch.Generator().manual_seed(seed), device=device)
    return TrackerSpec(params=params(), net=net)
