"""Multi-object training datasets for TaMOs (counterpart of
pytracking_tpu/training/datasets/mot_datasets.py `MSCOCOMOTSeq`,
`ImagenetVIDMOT`): each frame's annotation is a {track id: (x, y, w, h)}
dict. MSCOCOMOTSeq makes one single-frame sequence of the instances of each
image (at most max_objects); ImagenetVIDMOT one sequence of the tracklets
of each video with min_tracks or more, over the video's frames."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import List, Optional

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import (BaseImageDataset, BaseVideoDataset,
                                                         require_dir)
from pytracking_tpu_torch.training.datasets.imagenetvid import ImagenetVID, video_dir


class MSCOCOMOTSeq(BaseImageDataset):
    def __init__(self, root: str, split: str = "train", version: str = "2017",
                 min_area: float = 50.0, max_objects: int = 10):
        super().__init__("coco_mot", require_dir(root, "COCO"))
        with open(os.path.join(root, "annotations", f"instances_{split}{version}.json")) as f:
            data = json.load(f)
        self.img_info = {im["id"]: im for im in data["images"]}
        self.img_prefix = os.path.join(root, f"{split}{version}")
        by_image = defaultdict(list)
        for a in data["annotations"]:
            if not a.get("iscrowd", 0) and a["bbox"][2] * a["bbox"][3] > min_area:
                by_image[a["image_id"]].append(a)
        self.sequence_list = [(img_id, annos[:max_objects])
                              for img_id, annos in by_image.items() if annos]

    def is_mot_dataset(self):
        return True

    def get_sequence_info(self, seq_id: int):
        _, annos = self.sequence_list[seq_id]
        bbox = [{str(i): np.asarray(a["bbox"], np.float32) for i, a in enumerate(annos)}]
        return {"bbox": bbox, "num_tracks": len(annos)}

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        img_id, _ = self.sequence_list[seq_id]
        img = _read_image(os.path.join(self.img_prefix, self.img_info[img_id]["file_name"]))
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frames = [img for _ in frame_ids]
        frame_anno = {"bbox": [anno["bbox"][0] for _ in frame_ids]}
        return frames, frame_anno, {"object_class_name": None}


class ImagenetVIDMOT(BaseVideoDataset):
    def __init__(self, root: str, min_tracks: int = 2, max_objects: int = 10):
        super().__init__("imagenet_vid_mot", root)
        by_video = defaultdict(list)
        for s in ImagenetVID(root).sequence_list:
            by_video[(s["set_id"], s["vid_id"])].append(s)
        self.videos = [(k, v[:max_objects]) for k, v in by_video.items()
                       if len(v) >= min_tracks]
        self.sequence_list = self.videos

    def is_mot_dataset(self):
        return True

    def get_sequence_info(self, seq_id: int):
        _, tracks = self.videos[seq_id]
        length = max(t["start_frame"] + len(t["anno"]) for t in tracks)
        bbox = []
        for f in range(length):
            d = {}
            for i, t in enumerate(tracks):
                j = f - t["start_frame"]
                if 0 <= j < len(t["anno"]):
                    d[str(i)] = np.asarray(t["anno"][j], np.float32)
            bbox.append(d)
        return {"bbox": bbox, "num_tracks": len(tracks)}

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        (set_id, vid_id), _ = self.videos[seq_id]
        vdir = video_dir(self.root, set_id, vid_id)
        frames = [_read_image(os.path.join(vdir, f"{t:06d}.JPEG")) for t in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_anno = {"bbox": [anno["bbox"][t] for t in frame_ids]}
        return frames, frame_anno, {"object_class_name": None}
