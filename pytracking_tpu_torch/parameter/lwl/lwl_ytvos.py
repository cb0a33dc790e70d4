"""LWL parameters for YouTube-VOS (counterpart of
pytracking_tpu/parameter/lwl/lwl_ytvos.py).

No LWL checkpoint is in the repository, so the weights are drawn from a
seeded torch.Generator. `weights_bf16=True` is the counterpart of
PYTRACKING_TPU_BF16=1 (`maybe_bf16_variables`): every weight is rounded
through bf16 and the net still computes in float32, as flax promotes
bf16 parameters with float32 activations.
"""

import torch

from pytracking_tpu_torch.models.lwl.lwl_net import steepest_descent_resnet50
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.lwl import LWLParams
from pytracking_tpu_torch.utils.loading import round_to_bf16_


def params() -> LWLParams:
    return LWLParams()


def parameters(device="cuda", seed: int = 0, weights_bf16: bool = False) -> TrackerSpec:
    net = steepest_descent_resnet50(filter_size=3, num_filters=16, optim_iter=5,
                                    out_feature_dim=512, label_encoder_dims=(16, 32, 64),
                                    generator=torch.Generator().manual_seed(seed), device=device)
    if weights_bf16:
        round_to_bf16_(net)
    return TrackerSpec(params=params(), net=net)
