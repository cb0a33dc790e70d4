"""ATOM over five scales without the IoU-Net (counterpart of
pytracking_tpu/parameter/atom/multiscale_no_iounet.py): the scale of the
best-scoring sample becomes the target's."""

import dataclasses

from pytracking_tpu_torch.parameter.atom import default
from pytracking_tpu_torch.trackers.atom import ATOMParams
from pytracking_tpu_torch.trackers.base import TrackerSpec


def params() -> ATOMParams:
    return dataclasses.replace(default.params(), use_iou_net=False,
                               scale_factors=tuple(float(1.02 ** x) for x in (-2, -1, 0, 1, 2)))


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    return default.build_spec(params(), device, seed)
