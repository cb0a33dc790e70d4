"""DiMP-18 VOT2018 parameters (counterpart of
pytracking_tpu/parameter/dimp/dimp18_vot18.py): DiMP-50's VOT2018 settings
with the ResNet-18 net."""

from pytracking_tpu_torch.parameter.dimp import dimp18
from pytracking_tpu_torch.parameter.dimp.dimp50_vot18 import params  # noqa: F401
from pytracking_tpu_torch.trackers.base import TrackerSpec


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    return TrackerSpec(params=params(), net=dimp18.build_net(device, seed))
