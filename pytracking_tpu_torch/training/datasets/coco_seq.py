"""MS-COCO's instances as training samples (counterpart of
pytracking_tpu/training/datasets/coco_seq.py `MSCOCOSeq`, `MSCOCO`):
<root>/annotations/instances_<split><version>.json and the images under
<root>/<split><version>/. Each instance that is not a crowd and has a box
of more than `min_area` pixels is a sequence of one frame, read without
pycocotools. Its mask is its polygons filled with PIL's ImageDraw (the JAX
package's rasterisation, bit for bit; OpenCV's fillPoly fills other edge
pixels), or its box where the segmentation is run-length encoded."""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import BaseImageDataset, require_dir


def polygon_mask(a: dict, shape) -> np.ndarray:
    """(H, W) float32 mask of a COCO annotation: its polygons of 3 points or
    more filled by PIL, else its box."""
    seg = a.get("segmentation")
    m = np.zeros(shape[:2], np.float32)
    if isinstance(seg, list) and seg and isinstance(seg[0], list):
        from PIL import Image, ImageDraw
        img = Image.new("L", (shape[1], shape[0]), 0)
        draw = ImageDraw.Draw(img)
        for poly in seg:
            if len(poly) >= 6:
                draw.polygon([tuple(p) for p in np.asarray(poly).reshape(-1, 2)], fill=1)
        m = np.asarray(img, np.float32)
    else:
        x, y, w, h = [int(v) for v in a["bbox"]]
        m[y:y + max(h, 1), x:x + max(w, 1)] = 1.0
    return m


class MSCOCOSeq(BaseImageDataset):
    def __init__(self, root: str, split: str = "train", version: str = "2017",
                 min_area: float = 50.0):
        super().__init__("coco", require_dir(root, "COCO"))
        with open(os.path.join(root, "annotations", f"instances_{split}{version}.json")) as f:
            data = json.load(f)
        self.img_info = {im["id"]: im for im in data["images"]}
        self.img_prefix = os.path.join(root, f"{split}{version}")
        self.sequence_list = [a for a in data["annotations"]
                              if not a.get("iscrowd", 0)
                              and a["bbox"][2] * a["bbox"][3] > min_area]
        self.cats = {c["id"]: c["name"] for c in data.get("categories", [])}

    def has_class_info(self):
        return True

    def has_segmentation_info(self):
        return True

    def get_sequence_info(self, seq_id: int):
        a = self.sequence_list[seq_id]
        bbox = np.asarray(a["bbox"], np.float32).reshape(1, 4)
        valid = np.array([bbox[0, 2] > 0 and bbox[0, 3] > 0])
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def _image(self, a):
        return _read_image(os.path.join(self.img_prefix, self.img_info[a["image_id"]]["file_name"]))

    def get_frames(self, seq_id: int, frame_ids, anno=None):
        a = self.sequence_list[seq_id]
        img = self._image(a)
        frames = [img for _ in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_anno = {k: [v[0] for _ in frame_ids] for k, v in anno.items()}
        mask = polygon_mask(a, img.shape)
        frame_anno["mask"] = [mask for _ in frame_ids]
        return frames, frame_anno, {"object_class_name": self.cats.get(a.get("category_id"))}


class MSCOCO(MSCOCOSeq):
    """MS-COCO as an image dataset (get_image, get_image_info,
    get_images_in_class): one image per instance."""

    def get_num_images(self):
        return len(self.sequence_list)

    def get_image_info(self, im_id: int):
        return self.get_sequence_info(im_id)

    def get_class_name(self, im_id: int):
        return self.cats.get(self.sequence_list[im_id].get("category_id"))

    def get_images_in_class(self, class_name: str):
        return [i for i, a in enumerate(self.sequence_list)
                if self.cats.get(a.get("category_id")) == class_name]

    def get_image(self, image_id: int, anno: Optional[dict] = None):
        a = self.sequence_list[image_id]
        img = self._image(a)
        if anno is None:
            anno = self.get_image_info(image_id)
        anno = {k: v[0] for k, v in anno.items()}
        anno["mask"] = polygon_mask(a, img.shape)
        return img, anno, {"object_class_name": self.cats.get(a.get("category_id"))}
