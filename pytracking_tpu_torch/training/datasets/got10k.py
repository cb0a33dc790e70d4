"""GOT-10k's training sequences (counterpart of
pytracking_tpu/training/datasets/got10k.py `Got10k`): <root>/<name>/
{%08d.jpg counted from 1, groundtruth.txt, absence.label, cover.label},
named in <root>/list.txt (else every folder). A split keeps the entries of
list.txt whose indices its upstream data spec lists (_SPLIT_FILES); seq_ids
keeps the indices given. A frame is visible where its box has an area, the
target is not absent and its cover is above 0."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import BaseVideoDataset, require_dir
from pytracking_tpu_torch.training.datasets.data_specs import load_int_spec

_SPLIT_FILES = {"train": "got10k_train_split.txt",
                "val": "got10k_val_split.txt",
                "vottrain": "got10k_vot_train_split.txt",
                "votval": "got10k_vot_val_split.txt"}


class Got10k(BaseVideoDataset):
    def __init__(self, root: str, split: Optional[str] = None, seq_ids=None):
        super().__init__("got10k", require_dir(root, "GOT-10k"))
        list_file = os.path.join(root, "list.txt")
        if os.path.isfile(list_file):
            with open(list_file) as f:
                self.sequence_list = [line.strip() for line in f if line.strip()]
        else:
            self.sequence_list = sorted(
                d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if split is not None:
            if seq_ids is not None:
                raise ValueError("Cannot set both split and seq_ids.")
            if split not in _SPLIT_FILES:
                raise ValueError(f"Unknown split name {split!r}.")
            seq_ids = load_int_spec(_SPLIT_FILES[split], root)
        if seq_ids is not None:
            self.sequence_list = [self.sequence_list[i] for i in seq_ids]

    def has_occlusion_info(self):
        return True

    def get_sequence_info(self, seq_id: int):
        seq_dir = os.path.join(self.root, self.sequence_list[seq_id])
        bbox = np.loadtxt(os.path.join(seq_dir, "groundtruth.txt"),
                          delimiter=",").reshape(-1, 4).astype(np.float32)
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        visible = valid.copy()
        occ_path = os.path.join(seq_dir, "absence.label")
        cover_path = os.path.join(seq_dir, "cover.label")
        if os.path.isfile(occ_path):
            absence = np.loadtxt(occ_path).reshape(-1).astype(bool)
            n = min(len(absence), len(visible))
            visible[:n] &= ~absence[:n]
        if os.path.isfile(cover_path):
            cover = np.loadtxt(cover_path).reshape(-1)
            n = min(len(cover), len(visible))
            visible[:n] &= cover[:n] > 0
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def get_frames(self, seq_id: int, frame_ids, anno=None):
        seq_dir = os.path.join(self.root, self.sequence_list[seq_id])
        frames = [_read_image(os.path.join(seq_dir, f"{i + 1:08d}.jpg"))
                  for i in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_anno = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_anno, {"object_class_name": None}
