"""Sequence and dataset containers of the evaluation harness (counterpart of
pytracking_tpu/evaluation/data.py). Ground-truth boxes are (x, y, w, h) per
frame; `init_data` holds the initialisation of each frame that starts an
object."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class BaseDataset:
    def __init__(self):
        from pytracking_tpu_torch.evaluation.environment import env_settings
        self.env_settings = env_settings()

    def __len__(self):
        return len(self.get_sequence_list())

    def get_sequence_list(self) -> "SequenceList":
        raise NotImplementedError


class Sequence:
    """One video: frame paths (or synthetic:// URIs), ground truth, the
    initialisation data and, for multi-object datasets, the object ids."""

    def __init__(self, name: str, frames: List[str], dataset: str,
                 ground_truth_rect, ground_truth_seg=None, init_data: dict = None,
                 object_class: str = None, target_visible=None,
                 object_ids: Optional[List[str]] = None,
                 multiobj_mode: bool = False, attributes=None):
        self.name = name
        self.frames = frames
        self.dataset = dataset
        self.attributes = attributes or []
        if isinstance(ground_truth_rect, dict):   # multi-object: {obj_id: (N, 4)}
            self.ground_truth_rect = {k: np.asarray(v) for k, v in ground_truth_rect.items()}
        else:
            self.ground_truth_rect = np.asarray(ground_truth_rect) \
                if ground_truth_rect is not None else None
        self.ground_truth_seg = ground_truth_seg
        self.object_class = object_class
        self.target_visible = np.asarray(target_visible) if target_visible is not None else None
        self.object_ids = object_ids
        self.multiobj_mode = multiobj_mode
        self.init_data = self._construct_init_data(init_data)

    def _construct_init_data(self, init_data):
        if init_data is not None:
            return init_data
        init_bbox = None
        if isinstance(self.ground_truth_rect, dict):
            init_bbox = {oid: list(map(float, r[0] if r.ndim == 2 else r))
                         for oid, r in self.ground_truth_rect.items()}
        elif self.ground_truth_rect is not None:
            rect = self.ground_truth_rect
            init_bbox = list(map(float, rect[0] if rect.ndim == 2 else rect))
        d = {"bbox": init_bbox}
        # a SOT dataset in VOS mode carries a first-frame mask
        if self.ground_truth_seg is not None and len(self.ground_truth_seg) and \
                self.ground_truth_seg[0] is not None:
            d["mask"] = self.ground_truth_seg[0]
        if self.object_ids is not None:
            d["object_ids"] = self.object_ids
        return {0: d}

    def init_info(self) -> dict:
        return self.frame_info(0)

    def frame_info(self, frame_num: int) -> dict:
        return self.object_init_data(frame_num)

    def init_bbox(self, frame_num: int = 0):
        return self.object_init_data(frame_num).get("init_bbox")

    def object_init_data(self, frame_num: int = 0) -> dict:
        """The frame's initialisation with 'init_' keys ({} if none); a
        mask given as a path is read here."""
        if frame_num not in self.init_data:
            return {}
        out = {}
        for k, v in self.init_data[frame_num].items():
            if v is not None:
                out["init_" + k if not k.startswith("object_ids") else k] = v
        if isinstance(out.get("init_mask"), str):
            from pytracking_tpu_torch.utils.png_io import imread_indexed
            out["init_mask"] = imread_indexed(out["init_mask"])
        return out

    def __len__(self):
        return len(self.frames)

    def __repr__(self):
        return f"Sequence({self.name}, {len(self.frames)} frames)"


class SequenceList(list):
    """A list of sequences that is also indexed by sequence name."""

    def __getitem__(self, item):
        if isinstance(item, str):
            for seq in self:
                if seq.name == item:
                    return seq
            raise IndexError(f"Sequence name not in the dataset: {item}")
        if isinstance(item, int):
            return super().__getitem__(item)
        return SequenceList(super().__getitem__(item))
