"""Box datasets with masks (counterpart of
pytracking_tpu/training/datasets/vos_wrappers.py `make_got10k_vos`,
`make_lasot_vos`, `LVIS`): GOT-10k and LaSOT with pseudo-masks as indexed
PNGs (object where the label is above 0) in a tree under `mask_root` that
mirrors the sequences' own, <mask_root>/<sequence>/%08d.png counted from 1
(a frame without one gets an empty mask); LVIS, COCO-format instances in
<root>/lvis_v1_<split>.json over the COCO images."""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import BaseImageDataset, require_dir
from pytracking_tpu_torch.training.datasets.coco_seq import MSCOCOSeq
from pytracking_tpu_torch.training.datasets.got10k import Got10k
from pytracking_tpu_torch.training.datasets.lasot import Lasot
from pytracking_tpu_torch.utils.png_io import imread_indexed


class _VOSMaskMixin:
    """Adds 'mask' to get_frames from <mask_root>/<sequence>/%08d.png. The
    sequence is the entry of sequence_list: LaSOT's is <class>/<class>-<id>."""

    mask_root: str = ""

    def _load_mask(self, seq_id, frame_id, shape):
        p = os.path.join(self.mask_root, self.sequence_list[seq_id], f"{frame_id + 1:08d}.png")
        if os.path.isfile(p):
            return (imread_indexed(p) > 0).astype(np.float32)
        return np.zeros(shape[:2], np.float32)

    def has_segmentation_info(self):
        return True

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        frames, frame_anno, meta = super().get_frames(seq_id, frame_ids, anno)
        frame_anno["mask"] = [self._load_mask(seq_id, t, frames[0].shape) for t in frame_ids]
        return frames, frame_anno, meta


class _Got10kVOS(_VOSMaskMixin, Got10k):
    def __init__(self, root: str, mask_root: str, **kwargs):
        super().__init__(root, **kwargs)
        self.mask_root = require_dir(mask_root, "GOT-10k masks")


class _LasotVOS(_VOSMaskMixin, Lasot):
    def __init__(self, root: str, mask_root: str, **kwargs):
        super().__init__(root, **kwargs)
        self.mask_root = require_dir(mask_root, "LaSOT masks")


def make_got10k_vos(root: str, mask_root: str, **kwargs) -> Got10k:
    """GOT-10k's boxes with its pseudo-masks; kwargs go to Got10k."""
    return _Got10kVOS(root, mask_root, **kwargs)


def make_lasot_vos(root: str, mask_root: str, **kwargs) -> Lasot:
    """LaSOT's boxes with its pseudo-masks; kwargs go to Lasot."""
    return _LasotVOS(root, mask_root, **kwargs)


class LVIS(MSCOCOSeq):
    """LVIS: the instances with a box of more than `min_area` pixels; an
    image's path is the last two parts of its coco_url under `root`
    (<root>/train2017/<file>), else its file_name."""

    def __init__(self, root: str, split: str = "train", min_area: float = 50.0):
        BaseImageDataset.__init__(self, "lvis", require_dir(root, "LVIS"))
        with open(os.path.join(root, f"lvis_v1_{split}.json")) as f:
            data = json.load(f)
        self.img_info = {im["id"]: im for im in data["images"]}
        self.img_prefix = root
        self.sequence_list = [a for a in data["annotations"]
                              if a["bbox"][2] * a["bbox"][3] > min_area]
        self.cats = {c["id"]: c.get("name", "") for c in data.get("categories", [])}

    def _image(self, a):
        im_info = self.img_info[a["image_id"]]
        rel = im_info.get("coco_url", "").split("/")[-2:]
        rel = os.path.join(*rel) if len(rel) == 2 else im_info.get("file_name", "")
        return _read_image(os.path.join(self.img_prefix, rel))
