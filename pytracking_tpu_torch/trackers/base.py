"""Tracker interface (counterpart of pytracking_tpu/trackers/base.py).

`initialize(image, info) -> dict` and `track(image, info) -> dict`, with
'target_bbox' (x, y, w, h) and 'object_presence_score' in the outputs. A
tracker keeps its per-frame state as fixed-shape tensors on its device;
`track` reads back only the small output dict. The JAX package's shape
buckets and jit plumbing are XLA machinery and have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from pytracking_tpu_torch.utils.device import resolve_device


@dataclass
class TrackerSpec:
    """What a parameter module returns: tracker parameters and the network."""
    params: Any
    net: nn.Module


class BaseTracker:
    def __init__(self, params, device="cuda"):
        self.params = params
        self.device = resolve_device(device)

    def _image_tensor(self, image) -> torch.Tensor:
        """Host frame (H, W, 3) -> (3, H, W) float32 on the tracker's device."""
        arr = np.ascontiguousarray(np.asarray(image))
        return torch.from_numpy(arr).to(self.device).permute(2, 0, 1).float()

    def initialize(self, image, info: Dict[str, Any]) -> Optional[dict]:
        raise NotImplementedError

    def track(self, image, info: Optional[dict] = None) -> dict:
        raise NotImplementedError
