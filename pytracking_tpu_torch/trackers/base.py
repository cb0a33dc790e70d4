"""Tracker interface (counterpart of pytracking_tpu/trackers/base.py).

`initialize(image, info) -> dict` and `track(image, info) -> dict`, with
'target_bbox' (x, y, w, h) and 'object_presence_score' in the outputs. A
tracker keeps its per-frame state as fixed-shape tensors on its device;
`track` reads back only the small output dict. The JAX package's shape
buckets and jit plumbing are XLA machinery and have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from pytracking_tpu_torch.utils.device import resolve_device


def take(x: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """x[ind] for a 0-dim index tensor, without reading it on the host."""
    return x.index_select(0, ind.reshape(1).long())[0]


def masked_slot_set(buf: torch.Tensor, ind: torch.Tensor, value: torch.Tensor,
                    do_update: torch.Tensor) -> None:
    """In place: buf[ind] = value where do_update, else buf[ind] keeps its
    contents. Only the chosen slot is read and written; `ind` stays on the
    device."""
    slot = torch.where(do_update, value, take(buf, ind))
    buf.index_copy_(0, ind.reshape(1).long(), slot[None])


@dataclass
class TrackerSpec:
    """What a parameter module returns: tracker parameters, the network and
    further keyword arguments of the tracker (KeepTrack's matching net)."""
    params: Any
    net: nn.Module
    tracker_kwargs: Dict[str, Any] = field(default_factory=dict)


class BaseTracker:
    def __init__(self, params, device="cuda"):
        self.params = params
        self.device = resolve_device(device)

    def _image_tensor(self, image) -> torch.Tensor:
        """Host frame (H, W, 3) -> (3, H, W) float32 on the tracker's device.
        A card gets the frame from pinned memory without waiting: a pageable
        upload would synchronise the host with the card's queue."""
        frame = torch.from_numpy(np.ascontiguousarray(np.asarray(image)))
        if self.device.type == "cuda":
            frame = frame.pin_memory()
        return frame.to(self.device, non_blocking=True).permute(2, 0, 1).float()

    def initialize(self, image, info: Dict[str, Any]) -> Optional[dict]:
        raise NotImplementedError

    def track(self, image, info: Optional[dict] = None) -> dict:
        raise NotImplementedError
