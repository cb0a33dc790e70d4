"""KYS VOT parameters (counterpart of pytracking_tpu/parameter/kys/default_vot.py):
a 224x224 sample at search area 4, a large memory, a tighter clipped output
window, and hard-negative mining on the DiMP score. The net is the default
module's: the network file `kys` when it exists, else seeded."""

import dataclasses

import torch

from pytracking_tpu_torch.models.tracking.kysnet import kysnet_res50
from pytracking_tpu_torch.parameter.kys import default
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.kys import KYSParams


def params() -> KYSParams:
    return dataclasses.replace(
        default.params(), image_sample_size=14 * 16, search_area_scale=4.0,
        sample_memory_size=250, learning_rate=0.0075, init_samples_minimum_weight=0.0,
        train_skipping=10, net_opt_iter=25, net_opt_update_iter=3, net_opt_hn_iter=3,
        effective_search_area=4.0, perform_hn_mining_dimp=True,
        target_neighborhood_scale_safe=2.2)


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    net = load_or_seeded("kys", lambda: kysnet_res50(
        generator=torch.Generator().manual_seed(seed), device=device), device)
    return TrackerSpec(params=params(), net=net)
