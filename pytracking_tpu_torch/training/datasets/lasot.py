"""LaSOT's training sequences (counterpart of
pytracking_tpu/training/datasets/lasot.py `Lasot`): <root>/<class>/<class>-<id>/
{img/%08d.jpg counted from 1, groundtruth.txt, full_occlusion.txt,
out_of_view.txt}. split='train' keeps the names of the upstream
`lasot_train_split.txt` data spec (training/datasets/data_specs.py);
vid_ids keeps the ids given; neither keeps every sequence on disk. A frame
is visible where it is neither fully occluded nor out of view and its box
has an area."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import BaseVideoDataset, require_dir
from pytracking_tpu_torch.training.datasets.data_specs import load_str_spec


class Lasot(BaseVideoDataset):
    def __init__(self, root: str, split: Optional[str] = None,
                 vid_ids: Optional[List[int]] = None):
        super().__init__("lasot", require_dir(root, "LaSOT"))
        self.sequence_list = self._build_sequence_list(split, vid_ids)

    def _build_sequence_list(self, split, vid_ids):
        if split is not None:
            if vid_ids is not None:
                raise ValueError("Cannot set both split and vid_ids.")
            if split != "train":
                raise ValueError(f"Unknown split name {split!r}.")
            names = load_str_spec("lasot_train_split.txt", self.root)
            return [os.path.join(n.split("-")[0], n) for n in names]
        seqs = []
        for cls in sorted(os.listdir(self.root)):
            cls_dir = os.path.join(self.root, cls)
            if not os.path.isdir(cls_dir):
                continue
            for s in sorted(os.listdir(cls_dir)):
                if not os.path.isdir(os.path.join(cls_dir, s, "img")):
                    continue
                vid = int(s.rsplit("-", 1)[1])
                if vid_ids is not None and vid not in vid_ids:
                    continue
                seqs.append(os.path.join(cls, s))
        return seqs

    def has_class_info(self):
        return True

    def get_sequence_info(self, seq_id: int):
        seq_dir = os.path.join(self.root, self.sequence_list[seq_id])
        bbox = np.loadtxt(os.path.join(seq_dir, "groundtruth.txt"),
                          delimiter=",").reshape(-1, 4).astype(np.float32)
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        occ = np.loadtxt(os.path.join(seq_dir, "full_occlusion.txt"),
                         delimiter=",").reshape(-1)
        oov = np.loadtxt(os.path.join(seq_dir, "out_of_view.txt"),
                         delimiter=",").reshape(-1)
        n = min(len(bbox), len(occ), len(oov))
        visible = (occ[:n] == 0) & (oov[:n] == 0) & valid[:n]
        return {"bbox": bbox[:n], "valid": valid[:n], "visible": visible}

    def get_frames(self, seq_id: int, frame_ids, anno=None):
        seq_dir = os.path.join(self.root, self.sequence_list[seq_id])
        frames = [_read_image(os.path.join(seq_dir, "img", f"{i + 1:08d}.jpg"))
                  for i in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_anno = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        cls = self.sequence_list[seq_id].split(os.sep)[0]
        return frames, frame_anno, {"object_class_name": cls}
