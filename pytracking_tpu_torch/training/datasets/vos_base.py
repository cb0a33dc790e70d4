"""Video object segmentation training datasets (counterpart of
pytracking_tpu/training/datasets/vos_base.py `_mask_to_bbox`,
`VOSDatasetBase`, `Davis`, `YouTubeVOS`): frames under <img_root>/<seq>/
and indexed PNG label maps under <anno_root>/<seq>/ of the same stem. The
objects are the labels of a sequence's first label map; each (sequence,
object) is one single-object sequence whose mask is where the label map
holds its id and whose box is that mask's extent (a frame without a label
map is invalid). A sequence's info reads every label map of it, so it is
kept after its first reading, as upstream keeps it in its meta file."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import BaseVideoDataset, require_dir
from pytracking_tpu_torch.utils.png_io import imread_indexed


def _mask_to_bbox(mask: np.ndarray) -> np.ndarray:
    """(x, y, w, h) float32 of a mask's nonzero pixels; zeros where there
    are none."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    return np.asarray([x0, y0, x1 - x0 + 1, y1 - y0 + 1], np.float32)


class VOSDatasetBase(BaseVideoDataset):
    def __init__(self, name: str, img_root: str, anno_root: str,
                 sequences: Optional[List[str]] = None, multiobj: bool = False):
        super().__init__(name, require_dir(img_root, name))
        self.img_root = img_root
        self.anno_root = require_dir(anno_root, name)
        self.multiobj = multiobj
        self.sequence_list = []
        self._frames: Dict[str, List[str]] = {}
        self._infos: Dict[int, dict] = {}
        for sname in sequences or sorted(os.listdir(img_root)):
            sdir = os.path.join(img_root, sname)
            adir = os.path.join(anno_root, sname)
            if not os.path.isdir(sdir) or not os.path.isdir(adir):
                continue
            self._frames[sname] = sorted(f for f in os.listdir(sdir)
                                         if f.lower().endswith((".jpg", ".jpeg", ".png")))
            m = imread_indexed(os.path.join(adir, sorted(os.listdir(adir))[0]))
            obj_ids = [int(i) for i in np.unique(m) if i != 0]
            if multiobj:
                self.sequence_list.append((sname, obj_ids))
            else:
                self.sequence_list.extend((sname, oid) for oid in obj_ids)

    def has_segmentation_info(self):
        return True

    def _load_mask(self, sname, frame_name, obj_id):
        p = os.path.join(self.anno_root, sname, os.path.splitext(frame_name)[0] + ".png")
        if not os.path.isfile(p):
            return None
        return (imread_indexed(p) == obj_id).astype(np.float32)

    def get_sequence_info(self, seq_id: int):
        if seq_id in self._infos:
            return self._infos[seq_id]
        sname, obj_id = self.sequence_list[seq_id]
        boxes, valid = [], []
        for fn in self._frames[sname]:
            m = self._load_mask(sname, fn, obj_id)
            bb = np.zeros(4, np.float32) if m is None else _mask_to_bbox(m)
            boxes.append(bb)
            valid.append(m is not None and bb[2] > 0 and bb[3] > 0)
        valid = np.asarray(valid)
        info = {"bbox": np.stack(boxes), "valid": valid, "visible": valid.copy()}
        self._infos[seq_id] = info
        return info

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        sname, obj_id = self.sequence_list[seq_id]
        names = self._frames[sname]
        frames = [_read_image(os.path.join(self.img_root, sname, names[t])) for t in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_anno = {k: [v[t] for t in frame_ids] for k, v in anno.items()}
        masks = []
        for t in frame_ids:
            m = self._load_mask(sname, names[t], obj_id)
            masks.append(m if m is not None else np.zeros(frames[0].shape[:2], np.float32))
        frame_anno["mask"] = masks
        return frames, frame_anno, {"object_class_name": None}


class Davis(VOSDatasetBase):
    """DAVIS: <root>/JPEGImages/480p/, <root>/Annotations/480p/, the split's
    sequences from <root>/ImageSets/<version>/<split>.txt (every sequence
    where it is absent)."""

    def __init__(self, root: str, split: str = "train", version: str = "2017"):
        require_dir(root, "DAVIS")
        seq_file = os.path.join(root, "ImageSets", version, split + ".txt")
        sequences = None
        if os.path.isfile(seq_file):
            with open(seq_file) as f:
                sequences = [line.strip() for line in f if line.strip()]
        super().__init__("davis", os.path.join(root, "JPEGImages", "480p"),
                         os.path.join(root, "Annotations", "480p"), sequences)


class YouTubeVOS(VOSDatasetBase):
    """YouTube-VOS: <root>/<version>/<split>/{JPEGImages, Annotations}/."""

    def __init__(self, root: str, split: str = "train", version: str = "2019"):
        base = os.path.join(require_dir(root, "YouTube-VOS"), version, split)
        super().__init__("youtubevos", os.path.join(base, "JPEGImages"),
                         os.path.join(base, "Annotations"))
