"""LWL parameters for YouTube-VOS (counterpart of
pytracking_tpu/parameter/lwl/lwl_ytvos.py).

The net is the network file `lwl_stage2` when it exists; else, as no LWL
checkpoint is in the repository, its weights are drawn from a seeded
torch.Generator. `weights_bf16=True` is the counterpart of
PYTRACKING_TPU_BF16=1 (`maybe_bf16_variables`): every weight is rounded
through bf16 and the net still computes in float32, as flax promotes
bf16 parameters with float32 activations.
"""

import torch

from pytracking_tpu_torch.models.lwl.lwl_net import steepest_descent_resnet50
from pytracking_tpu_torch.parameter import precision
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.lwl import LWLParams
from pytracking_tpu_torch.utils.loading import round_to_bf16_

precision_kwargs = precision.weights_only


def params() -> LWLParams:
    return LWLParams()


def parameters(device="cuda", seed: int = 0, weights_bf16: bool = False) -> TrackerSpec:
    net = load_or_seeded("lwl_stage2", lambda: steepest_descent_resnet50(
        filter_size=3, num_filters=16, optim_iter=5, out_feature_dim=512,
        label_encoder_dims=(16, 32, 64), generator=torch.Generator().manual_seed(seed),
        device=device), device)
    if weights_bf16:
        round_to_bf16_(net)
    return TrackerSpec(params=params(), net=net)
