"""ImageNet-VID's tracklets as training sequences (counterpart of
pytracking_tpu/training/datasets/imagenetvid.py `_process_anno`,
`ImagenetVID`): the XML annotations under
<root>/Annotations/VID/train/<set>/<video>/ and the frames under
<root>/Data/VID/train/<set>/<video>/%06d.JPEG. Each track id of a video is
a sequence from its first frame to the frame before it is first missing.
The tracklets are parsed once into <root>/cache.json (upstream's cache name
and entry schema, so that either package reads the other's cache)."""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import BaseVideoDataset, require_dir


def _process_anno(root: str) -> List[dict]:
    """The tracklets of every video of the train XMLs: {set_id, vid_id,
    class_name, start_frame, anno (x, y, w, h per frame), target_visible}."""
    base = require_dir(os.path.join(root, "Annotations", "VID", "train"), "ImageNet-VID")
    all_sequences = []
    for set_name in sorted(os.listdir(base)):
        set_id = int(set_name.split("_")[-1])
        for vid in sorted(os.listdir(os.path.join(base, set_name))):
            vid_id = int(vid.split("_")[-1])
            vdir = os.path.join(base, set_name, vid)
            objects = [ET.parse(os.path.join(vdir, f)).findall("object")
                       for f in sorted(os.listdir(vdir))]
            tracklets = {}
            for f_id, targets in enumerate(objects):
                for t in targets:
                    tracklets.setdefault(t.find("trackid").text, f_id)
            for tid, start in tracklets.items():
                anno, visible = [], []
                class_name = None
                for f_id in range(start, len(objects)):
                    tgt = next((t for t in objects[f_id] if t.find("trackid").text == tid),
                               None)
                    if tgt is None:
                        break
                    class_name = class_name or tgt.find("name").text
                    x1 = int(tgt.find("bndbox/xmin").text)
                    y1 = int(tgt.find("bndbox/ymin").text)
                    x2 = int(tgt.find("bndbox/xmax").text)
                    y2 = int(tgt.find("bndbox/ymax").text)
                    anno.append([x1, y1, x2 - x1, y2 - y1])
                    visible.append(tgt.find("occluded").text == "0")
                all_sequences.append({"set_id": set_id, "vid_id": vid_id,
                                      "class_name": class_name, "start_frame": start,
                                      "anno": anno, "target_visible": visible})
    return all_sequences


def video_dir(root: str, set_id: int, vid_id: int) -> str:
    return os.path.join(root, "Data", "VID", "train", f"ILSVRC2015_VID_train_{set_id:04d}",
                        f"ILSVRC2015_train_{vid_id:08d}")


class ImagenetVID(BaseVideoDataset):
    def __init__(self, root: str, min_length: int = 0):
        super().__init__("imagenet_vid", require_dir(root, "ImageNet-VID"))
        cache_file = os.path.join(root, "cache.json")
        if os.path.isfile(cache_file):
            with open(cache_file) as f:
                sequences = json.load(f)
        else:
            sequences = _process_anno(root)
            with open(cache_file, "w") as f:
                json.dump(sequences, f)
        self.sequence_list = [s for s in sequences if len(s["anno"]) >= min_length]

    def has_class_info(self):
        return True

    def get_sequence_info(self, seq_id: int):
        s = self.sequence_list[seq_id]
        bbox = np.asarray(s["anno"], np.float32)
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        visible = np.asarray(s["target_visible"], bool) & valid
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        s = self.sequence_list[seq_id]
        vdir = video_dir(self.root, s["set_id"], s["vid_id"])
        frames = [_read_image(os.path.join(vdir, f"{s['start_frame'] + t:06d}.JPEG"))
                  for t in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_anno = {k: [v[t] for t in frame_ids] for k, v in anno.items()}
        return frames, frame_anno, {"object_class_name": s["class_name"]}
