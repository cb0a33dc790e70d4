"""TaMOs-ResNet50 parameters (counterpart of
pytracking_tpu/parameter/tamos/tamos_resnet50.py).

The net is the network file `tamos_resnet50` when it exists; else, as no
TaMOs checkpoint is in the repository, its weights are drawn from a seeded
torch.Generator. `dtype=torch.bfloat16` runs the backbone and the
transformer in bf16 (float32 softmax, LayerNorm and residuals): the
counterpart of PYTRACKING_TPU_BF16=1.
"""

import torch

from pytracking_tpu_torch.models.tracking.tamosnet import tamosnet_resnet50
from pytracking_tpu_torch.parameter import precision
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.tamos import TaMOsParams

precision_kwargs = precision.dtype_only


def parameters(device="cuda", dtype: torch.dtype = torch.float32,
               seed: int = 0) -> TrackerSpec:
    params = TaMOsParams()
    dt = None if dtype == torch.float32 else dtype
    net = load_or_seeded("tamos_resnet50", lambda: tamosnet_resnet50(
        feature_sz=max(params.train_feature_size), num_tokens=params.num_tokens,
        backbone_dtype=dt, transformer_dtype=dt, generator=torch.Generator().manual_seed(seed),
        device=device), device, backbone_dtype=dt, transformer_dtype=dt)
    return TrackerSpec(params=params, net=net)
