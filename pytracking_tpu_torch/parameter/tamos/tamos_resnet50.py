"""TaMOs-ResNet50 parameters (counterpart of
pytracking_tpu/parameter/tamos/tamos_resnet50.py).

No TaMOs checkpoint is in the repository, so the weights are drawn from a
seeded torch.Generator. `dtype=torch.bfloat16` runs the backbone and the
transformer in bf16 (float32 softmax, LayerNorm and residuals): the
counterpart of PYTRACKING_TPU_BF16=1.
"""

import torch

from pytracking_tpu_torch.models.tracking.tamosnet import tamosnet_resnet50
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.tamos import TaMOsParams


def parameters(device="cuda", dtype: torch.dtype = torch.float32,
               seed: int = 0) -> TrackerSpec:
    params = TaMOsParams()
    dt = None if dtype == torch.float32 else dtype
    net = tamosnet_resnet50(feature_sz=max(params.train_feature_size),
                            num_tokens=params.num_tokens, backbone_dtype=dt,
                            transformer_dtype=dt,
                            generator=torch.Generator().manual_seed(seed), device=device)
    return TrackerSpec(params=params, net=net)
