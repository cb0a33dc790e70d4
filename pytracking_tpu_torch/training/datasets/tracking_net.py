"""TrackingNet's training sequences (counterpart of
pytracking_tpu/training/datasets/tracking_net.py `TrackingNet`):
<root>/TRAIN_<k>/anno/<name>.txt and <root>/TRAIN_<k>/frames/<name>/%d.jpg
counted from 0, for the sets `set_ids` (all 12 by default; a set not on
disk is passed over, and none on disk raises)."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import BaseVideoDataset, require_dir


class TrackingNet(BaseVideoDataset):
    def __init__(self, root: str, set_ids: Optional[Sequence[int]] = None):
        super().__init__("trackingnet", require_dir(root, "TrackingNet"))
        set_ids = set_ids if set_ids is not None else list(range(12))
        self.sequence_list = []
        found = False
        for sid in set_ids:
            anno_dir = os.path.join(root, f"TRAIN_{sid}", "anno")
            if not os.path.isdir(anno_dir):
                continue
            found = True
            for fn in sorted(os.listdir(anno_dir)):
                if fn.endswith(".txt"):
                    self.sequence_list.append((sid, fn[:-4]))
        if not found:
            raise FileNotFoundError(f"TrackingNet: none of TRAIN_{{{','.join(map(str, set_ids))}}}"
                                    f"/anno under {os.path.abspath(root)}")

    def get_sequence_info(self, seq_id: int):
        sid, name = self.sequence_list[seq_id]
        bbox = np.loadtxt(os.path.join(self.root, f"TRAIN_{sid}", "anno", name + ".txt"),
                          delimiter=",").reshape(-1, 4).astype(np.float32)
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id: int, frame_ids, anno=None):
        sid, name = self.sequence_list[seq_id]
        frames_dir = os.path.join(self.root, f"TRAIN_{sid}", "frames", name)
        frames = [_read_image(os.path.join(frames_dir, f"{i}.jpg")) for i in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_anno = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_anno, {"object_class_name": None}
