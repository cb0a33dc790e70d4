"""KeepTrack-fast parameters (counterpart of
pytracking_tpu/parameter/keep_track/default_fast.py): a 352x352 sample at
search area 6, 3 box-refinement steps and a candidate threshold of 0.1. The
nets are the default module's, the matcher's keypoint normalisation
included (480x480), as in the JAX module."""

import dataclasses

from pytracking_tpu_torch.parameter.keep_track import default
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.keep_track import KeepTrackParams


def params() -> KeepTrackParams:
    return dataclasses.replace(default.params(), image_sample_size=22 * 16,
                               search_area_scale=6.0, box_refinement_iter=3,
                               local_max_candidate_score_th=0.1)


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    return dataclasses.replace(default.parameters(device, seed), params=params())
