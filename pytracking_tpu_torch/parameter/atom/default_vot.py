"""ATOM VOT parameters (counterpart of
pytracking_tpu/parameter/atom/default_vot.py): a 224x224 sample at search
area 4 and the output window."""

import dataclasses

from pytracking_tpu_torch.parameter.atom import default
from pytracking_tpu_torch.trackers.atom import ATOMParams
from pytracking_tpu_torch.trackers.base import TrackerSpec


def params() -> ATOMParams:
    return dataclasses.replace(default.params(), max_image_sample_size=(14 * 16) ** 2,
                               min_image_sample_size=(14 * 16) ** 2, search_area_scale=4.0,
                               window_output=True)


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    return default.build_spec(params(), device, seed)
