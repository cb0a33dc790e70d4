"""TAO / BURST's multi-object training sequences for TaMOs (counterpart of
pytracking_tpu/training/datasets/tao_burst.py `TAOBURST`): <root>/TaoBurst.json
maps each sequence's name to {split, dataset_name, seq_name,
annotated_image_paths, track_ids, annotations: a {track id: (x, y, w, h)}
dict per annotated frame}; the frames lie under
<root>/annotated_frames/<split>/<dataset_name>/<seq_name>/. multiobj=True
gives each sequence with its per-frame dicts, multiobj=False one sequence
per track, its box (-1, -1, -1, -1) and invalid where the track is
absent."""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import BaseVideoDataset, require_dir


class TAOBURST(BaseVideoDataset):
    def __init__(self, root: str, multiobj: bool = True):
        super().__init__("taoburst", require_dir(root, "TAO-BURST"))
        with open(os.path.join(root, "TaoBurst.json")) as f:
            self.annos = json.load(f)
        self.multiobj = multiobj
        if multiobj:
            self.sequence_list = [(None, name) for name in self.annos]
        else:
            self.sequence_list = [(str(tid), name) for name in self.annos
                                  for tid in self.annos[name]["track_ids"]]

    def is_mot_dataset(self):
        return self.multiobj

    def get_sequence_info(self, seq_id: int):
        objid, name = self.sequence_list[seq_id]
        anno = self.annos[name]
        if objid is None:
            return {"bbox": anno["annotations"], "num_tracks": len(anno["track_ids"])}
        bbox = np.asarray([b.get(objid, [-1, -1, -1, -1]) for b in anno["annotations"]],
                          np.float32)
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        _, name = self.sequence_list[seq_id]
        a = self.annos[name]
        sdir = os.path.join(self.root, "annotated_frames", a["split"], a["dataset_name"],
                            a["seq_name"])
        frames = [_read_image(os.path.join(sdir, a["annotated_image_paths"][t]))
                  for t in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_anno = {k: [v[t] for t in frame_ids] for k, v in anno.items()
                      if k != "num_tracks"}
        return frames, frame_anno, {"object_class_name": None}
