"""ATOM with the GMM-sampled IoU head (counterpart of
pytracking_tpu/parameter/atom/atom_gmm_sampl.py): the default's, with the
box refinement in the relative box space, 10 steps of (1e-2, 5e-2) per
(pos, sz) coordinate."""

import dataclasses

from pytracking_tpu_torch.parameter.atom import default
from pytracking_tpu_torch.trackers.atom import ATOMParams
from pytracking_tpu_torch.trackers.base import TrackerSpec


def params() -> ATOMParams:
    return dataclasses.replace(default.params(), box_refinement_space="relative",
                               box_refinement_iter=10,
                               box_refinement_step_length=(1e-2, 5e-2))


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    return default.build_spec(params(), device, seed)
