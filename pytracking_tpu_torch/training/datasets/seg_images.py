"""Segmentation image datasets, the foregrounds of SyntheticVideoBlend
(counterpart of pytracking_tpu/training/datasets/seg_images.py
`SegImageDataset`, `ECSSD`, `MSRA10k`, `HKUIS`, `SBD`): images and binary
masks of the same stem in two folders of the root. A mask pixel is the
object where its grey value (PIL's 'L') is above 127; an image is valid
where its mask's box has more than `min_area` pixels."""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import BaseImageDataset, require_dir
from pytracking_tpu_torch.training.datasets.vos_base import _mask_to_bbox


class SegImageDataset(BaseImageDataset):
    def __init__(self, name: str, root: str, image_dir: str, mask_dir: str,
                 image_ext: str = ".jpg", mask_ext: str = ".png", min_area: float = 100.0):
        super().__init__(name, require_dir(root, name))
        self.image_dir = require_dir(os.path.join(root, image_dir), name)
        self.mask_dir = require_dir(os.path.join(root, mask_dir), name)
        self.image_ext = image_ext
        self.mask_ext = mask_ext
        self.min_area = min_area
        stems = sorted(os.path.splitext(os.path.basename(p))[0]
                       for p in glob.glob(os.path.join(self.image_dir, "*" + image_ext)))
        self.sequence_list = [s for s in stems
                              if os.path.isfile(os.path.join(self.mask_dir, s + mask_ext))]

    def has_segmentation_info(self):
        return True

    def _load(self, seq_id):
        from PIL import Image

        stem = self.sequence_list[seq_id]
        im = _read_image(os.path.join(self.image_dir, stem + self.image_ext))
        m = np.asarray(Image.open(os.path.join(self.mask_dir, stem + self.mask_ext)).convert("L"))
        return im, (m > 127).astype(np.float32)

    def get_sequence_info(self, seq_id: int):
        _, m = self._load(seq_id)
        bbox = _mask_to_bbox(m).reshape(1, 4)
        valid = np.array([bbox[0, 2] * bbox[0, 3] > self.min_area])
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        im, m = self._load(seq_id)
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_anno = {k: [v[0] for _ in frame_ids] for k, v in anno.items()}
        frame_anno["mask"] = [m for _ in frame_ids]
        return [im for _ in frame_ids], frame_anno, {"object_class_name": None}


class ECSSD(SegImageDataset):
    def __init__(self, root: str):
        super().__init__("ecssd", root, "images", "ground_truth_mask")


class MSRA10k(SegImageDataset):
    def __init__(self, root: str):
        super().__init__("msra10k", root, "Imgs", "Imgs")


class HKUIS(SegImageDataset):
    def __init__(self, root: str):
        super().__init__("hkuis", root, "imgs", "gt")


class SBD(SegImageDataset):
    """SBD in an img/ + masks/ layout of binary masks (upstream parses the
    .mat instance files)."""

    def __init__(self, root: str):
        super().__init__("sbd", root, "img", "masks")
