"""ToMP-50 parameters (counterpart of pytracking_tpu/parameter/tomp/tomp50.py).

No ToMP checkpoint is in the repository, so the weights are drawn from a
seeded torch.Generator. `dtype=torch.bfloat16` is the counterpart of
PYTRACKING_TPU_BF16=1: the backbone and the transformer compute in bf16
(float32 softmax, LayerNorm and residuals) and every weight is rounded
through bf16. `backbone_dtype=torch.bfloat16` alone is the counterpart of
PYTRACKING_TPU_BF16_BACKBONE=1: only the backbone computes in bf16.
"""

from typing import Optional

import torch

from pytracking_tpu_torch.models.tracking.tompnet import tompnet50
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.tomp import ToMPParams
from pytracking_tpu_torch.utils.loading import round_to_bf16_


def params() -> ToMPParams:
    return ToMPParams()


def parameters(device="cuda", dtype: torch.dtype = torch.float32, seed: int = 0,
               backbone_dtype: Optional[torch.dtype] = None) -> TrackerSpec:
    return build_spec(tompnet50, params(), device, dtype, seed, backbone_dtype)


def build_spec(net_fn, p: ToMPParams, device, dtype: torch.dtype, seed: int,
               backbone_dtype: Optional[torch.dtype]) -> TrackerSpec:
    """`p` and the net of `net_fn` (tompnet50 or tompnet101) at `dtype`."""
    bf16 = dtype == torch.bfloat16
    net = net_fn(feature_sz=p.train_feature_size,
                 backbone_dtype=torch.bfloat16 if bf16 else backbone_dtype,
                 transformer_dtype=torch.bfloat16 if bf16 else None,
                 generator=torch.Generator().manual_seed(seed), device=device)
    if bf16:
        round_to_bf16_(net)
    return TrackerSpec(params=p, net=net)
