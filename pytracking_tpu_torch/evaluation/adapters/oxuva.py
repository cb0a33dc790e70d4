"""OxUvA long-term tracking (counterpart of
pytracking_tpu/evaluation/adapters/oxuva.py).

Layout: <oxuva_path>/tasks/{dev,test}.csv (video, object, first and last
frame, the first box), <oxuva_path>/annotations/dev.csv (sparse boxes of
the dev split) and <oxuva_path>/images/<split>/<video>/<frame:06d>.jpeg.
Boxes in the files are normalised (xmin, xmax, ymin, ymax); they become
pixel (x, y, w, h) at the size of the task's first frame, read with PIL.
A frame without an annotation has the box -1.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList

_TASK_FIELDS = ["video_id", "object_id", "init_frame", "last_frame",
                "xmin", "xmax", "ymin", "ymax"]
_ANNO_FIELDS = ["video_id", "object_id", "class_id", "class_name", "contains_cuts",
                "always_visible", "frame_num", "object_presence",
                "xmin", "xmax", "ymin", "ymax"]


def _read_csv(path, fields):
    with open(path, newline="") as f:
        return [dict(zip(fields, raw)) for raw in csv.reader(f)]


class OxUvADataset(BaseDataset):
    """The dev (200 videos) and test (166 videos) splits."""

    def __init__(self, split: str = "dev"):
        super().__init__()
        if split not in ("dev", "test"):
            raise ValueError(f"Split {split} is not a valid option for OxUvA")
        self.base_path = dataset_root(self.env_settings, "oxuva_path")
        self.split = split
        self.tasks = _read_csv(os.path.join(self.base_path, "tasks", f"{split}.csv"),
                               _TASK_FIELDS)
        self.annos = _read_csv(os.path.join(self.base_path, "annotations", "dev.csv"),
                               _ANNO_FIELDS) if split == "dev" else []

    def get_sequence_list(self) -> SequenceList:
        return SequenceList([self._construct_sequence(i) for i in range(len(self.tasks))])

    def _frame_size(self, frame_path):
        from PIL import Image
        with Image.open(frame_path) as im:
            return im.size  # (w, h)

    def _construct_sequence(self, idx) -> Sequence:
        task = self.tasks[idx]
        vid, obj = task["video_id"], task["object_id"]
        f0, f1 = int(task["init_frame"]), int(task["last_frame"])
        name = f"{vid}_{obj}_frames[{f0:06d}:{f1 + 1:06d}]"
        frames_path = os.path.join(self.base_path, "images", self.split, vid)
        frames = [os.path.join(frames_path, f"{t:06d}.jpeg") for t in range(f0, f1 + 1)]
        w, h = self._frame_size(frames[0])

        gt = -np.ones((f1 - f0 + 1, 4))

        def to_xywh(row):
            x0, x1 = float(row["xmin"]) * w, float(row["xmax"]) * w
            y0, y1 = float(row["ymin"]) * h, float(row["ymax"]) * h
            return [x0, y0, x1 - x0, y1 - y0]

        if self.split == "test":
            gt[0] = to_xywh(task)
        else:
            for row in self.annos:
                if row["video_id"] == vid and row["object_id"] == obj:
                    t = int(row["frame_num"])
                    if f0 <= t <= f1:
                        gt[t - f0] = to_xywh(row)
        return Sequence(name, frames, "oxuva", gt.reshape(-1, 4))
