"""Synthetic training videos, made procedurally: a textured moving square
per sequence (counterpart of
pytracking_tpu/training/datasets/synthetic_video.py `SyntheticVideoDataset`,
`SyntheticVOSVideoDataset`), from the harness's renderer, so the training
stack runs with no data on disk."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pytracking_tpu_torch.evaluation.adapters.synthetic import (render_synthetic_frame,
                                                                synthetic_gt_center)
from pytracking_tpu_torch.training.datasets.base import BaseVideoDataset


class SyntheticVideoDataset(BaseVideoDataset):
    def __init__(self, num_sequences: int = 64, seq_len: int = 30,
                 H: int = 240, W: int = 320):
        super().__init__("synthetic_video", "")
        self.seq_len = seq_len
        self.H, self.W = H, W
        self.sequence_list = list(range(num_sequences))

    def get_sequence_info(self, seq_id: int):
        boxes = []
        for t in range(self.seq_len):
            cy, cx, sz = synthetic_gt_center(seq_id, t, self.H, self.W)
            boxes.append([cx - sz / 2, cy - sz / 2, sz, sz])
        bbox = np.asarray(boxes, np.float32)
        valid = np.ones(self.seq_len, bool)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        frames = [render_synthetic_frame(seq_id, t, self.H, self.W) for t in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_anno = {k: [v[t] for t in frame_ids] for k, v in anno.items()}
        return frames, frame_anno, {"object_class_name": "synthetic"}


class SyntheticVOSVideoDataset(SyntheticVideoDataset):
    """The synthetic videos with a segmentation mask per frame (the rendered
    target square, 1 inside and 0 outside), for the LWL and RTS recipes."""

    def has_segmentation_info(self) -> bool:
        return True

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        frames, frame_anno, meta = super().get_frames(seq_id, frame_ids, anno)
        masks = []
        for t in frame_ids:
            cy, cx, sz = synthetic_gt_center(seq_id, t, self.H, self.W)
            m = np.zeros((self.H, self.W), np.float32)
            y0, y1 = int(max(cy - sz / 2, 0)), int(min(cy + sz / 2, self.H))
            x0, x1 = int(max(cx - sz / 2, 0)), int(min(cx + sz / 2, self.W))
            m[y0:y1, x0:x1] = 1.0
            masks.append(m)
        frame_anno["mask"] = masks
        return frames, frame_anno, meta
