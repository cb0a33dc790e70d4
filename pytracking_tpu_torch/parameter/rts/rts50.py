"""RTS-50 parameters (counterpart of pytracking_tpu/parameter/rts/rts50.py).

The RTS net is the network file `rts50`, and the STA box-to-mask net, built
on the tracker's first start from a box (`sta_factory`), the file `sta`,
where they exist; else their weights come from seeded torch.Generators, the
RTS net's from `seed`, STA's from `seed + 1`. `weights_bf16` rounds the RTS
net's weights through bf16, as in `lwl_ytvos`.
"""

import torch

from pytracking_tpu_torch.models.lwl.sta_net import sta_resnet50
from pytracking_tpu_torch.models.rts.rts_net import rts50
from pytracking_tpu_torch.parameter import precision
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.rts import RTSParams
from pytracking_tpu_torch.utils.loading import round_to_bf16_

precision_kwargs = precision.weights_only


def params() -> RTSParams:
    return RTSParams()


def parameters(device="cuda", seed: int = 0, weights_bf16: bool = False) -> TrackerSpec:
    net = load_or_seeded("rts50", lambda: rts50(
        generator=torch.Generator().manual_seed(seed), device=device), device)
    if weights_bf16:
        round_to_bf16_(net)

    def sta_factory():
        return load_or_seeded("sta", lambda: sta_resnet50(
            generator=torch.Generator().manual_seed(seed + 1), device=device), device)

    return TrackerSpec(params=params(), net=net, tracker_kwargs={"sta_factory": sta_factory})
