"""TaMOs-SwinBase parameters (counterpart of
pytracking_tpu/parameter/tamos/tamos_swin_base.py).

No TaMOs checkpoint is in the repository, so the weights are drawn from a
seeded torch.Generator. The Swin backbone computes in float32;
`dtype=torch.bfloat16` runs the transformer in bf16 (float32 softmax,
LayerNorm and residuals): the counterpart of PYTRACKING_TPU_BF16=1 there.
"""

import torch

from pytracking_tpu_torch.models.tracking.tamosnet import tamosnet_swin_base
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.tamos import TaMOsParams


def parameters(device="cuda", dtype: torch.dtype = torch.float32,
               seed: int = 0) -> TrackerSpec:
    params = TaMOsParams()
    dt = None if dtype == torch.float32 else dtype
    net = tamosnet_swin_base(feature_sz=max(params.train_feature_size),
                             num_tokens=params.num_tokens, transformer_dtype=dt,
                             generator=torch.Generator().manual_seed(seed), device=device)
    return TrackerSpec(params=params, net=net)
