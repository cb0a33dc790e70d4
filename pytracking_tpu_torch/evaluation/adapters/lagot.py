"""LaGOT, LaSOT's many-object extension (counterpart of
pytracking_tpu/evaluation/adapters/lagot.py).

The annotations are one JSON file under `lagot_path` over LaSOT's frames
(paths relative to `lasot_path`). By default each sequence holds every
track (multiobj_mode, each track started at frame 0 where its first box
is valid); `sot_mode` reads the one-object-per-sequence file instead, in
which every third frame is annotated and a -1 box there is invisible.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList


class LaGOTDataset(BaseDataset):
    def __init__(self, sot_mode: bool = False):
        super().__init__()
        self.sot_mode = sot_mode
        self.base_path = dataset_root(self.env_settings, "lasot_path")
        fname = ("LaGOT_one_object_per_sequence_annotations_final.json" if sot_mode
                 else "LaGOT_multiple_object_per_sequence_annotations_final.json")
        with open(os.path.join(dataset_root(self.env_settings, "lagot_path"), fname)) as f:
            self.annos = json.load(f)
        self.sequence_list = list(self.annos.keys())

    def get_sequence_list(self) -> SequenceList:
        return SequenceList([self._construct_sequence(s) for s in self.sequence_list])

    def _construct_sequence(self, name) -> Sequence:
        anno = self.annos[name]
        frames = [os.path.join(self.base_path, p) for p in anno["frames"]]
        if self.sot_mode:
            gt = np.array(anno["xywh"]).reshape(-1, 4)
            visible = np.ones(gt.shape[0], dtype=bool)
            visible[::3] = np.all(gt[::3] >= 0, axis=1)
            return Sequence(name, frames, "LaGOT", gt, target_visible=visible)

        gt_bboxes = OrderedDict((tid, np.array(b)) for tid, b in anno["xywh"].items())
        init_data = {0: {"object_ids": [], "bbox": {}}}
        for tid, boxes in gt_bboxes.items():
            if np.all(boxes[0] > -1):
                init_data[0]["object_ids"].append(tid)
                init_data[0]["bbox"][tid] = np.array(boxes[0])
        return Sequence(name, frames, "LaGOT", gt_bboxes, init_data=init_data,
                        object_ids=list(gt_bboxes.keys()), multiobj_mode=True)

    def __len__(self):
        return len(self.sequence_list)
