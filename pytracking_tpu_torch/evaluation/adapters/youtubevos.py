"""YouTube-VOS 2018 / 2019 (counterpart of
pytracking_tpu/evaluation/adapters/youtubevos.py).

Layout: <youtubevos_dir>/<year>/<split>/{JPEGImages/<seq>/, Annotations/<seq>/,
meta.json}; meta.json lists each object's annotated frames, and an object
starts at its first (objects may appear mid-sequence).

  * `all_frames=True`: the frames come from <split>_all_frames/JPEGImages
    (the annotations stay with the split), as the evaluation server's
    submissions need every frame.
  * split 'jjvalid' / 'jjtrain': splits of the train folder, chosen by the
    upstream data spec youtubevos_<split>.txt.
  * `cleanup=['starts']`: the six objects whose first frames in meta.json
    are unlabelled start at their first labelled frame; 'aspect' leaves out
    sequences whose aspect ratio is outside [1.45, 1.9].
"""

from __future__ import annotations

import json
import os

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList

# (sequence, object id, the unlabelled first frames in meta.json, the first labelled one)
_BAD_START_FRAMES = [
    ("0e27472bea", "2", ["00055", "00060"], "00065"),
    ("5937b08d69", "4", ["00000"], "00005"),
    ("5e1ce354fd", "5", ["00010", "00015"], "00020"),
    ("7053e4f41e", "2", ["00000", "00005", "00010", "00015"], "00020"),
    ("720e3fa04c", "2", ["00050"], "00055"),
    ("c73c8e747f", "2", ["00035"], "00040"),
]


class YouTubeVOSDataset(BaseDataset):
    def __init__(self, version: str = "2019", split: str = "valid", all_frames: bool = False,
                 cleanup=None):
        super().__init__()
        self.version = version
        self.split = split
        self.all_frames = all_frames
        self.cleanup = set(cleanup) if cleanup else set()
        split_folder = "train" if split.startswith("jj") else split
        root = dataset_root(self.env_settings, "youtubevos_dir")
        self.base_path = os.path.join(root, version, split_folder)
        if all_frames:
            self.jpeg_path = os.path.join(root, version, split_folder + "_all_frames",
                                          "JPEGImages")
        else:
            self.jpeg_path = os.path.join(self.base_path, "JPEGImages")

    def _select_names(self, meta: dict):
        names = list(meta.keys())
        if self.split.startswith("jj"):
            from pytracking_tpu_torch.training.datasets.data_specs import load_str_spec
            keep = set(load_str_spec(f"youtubevos_{self.split}.txt"))
            names = [n for n in names if n in keep]
        if "aspect" in self.cleanup:
            from PIL import Image
            kept = []
            for n in names:
                img_dir = os.path.join(self.jpeg_path, n)
                first = sorted(os.listdir(img_dir))[0]
                with Image.open(os.path.join(img_dir, first)) as im:
                    a = im.width / im.height
                if 1.45 <= a <= 1.9:
                    kept.append(n)
            names = kept
        return names

    def get_sequence_list(self) -> SequenceList:
        from pytracking_tpu_torch.utils.png_io import imread_indexed

        base = self.base_path
        with open(os.path.join(base, "meta.json")) as f:
            meta = json.load(f)["videos"]

        bad_starts = {}
        if "starts" in self.cleanup:
            for seq, oid, bad, good in _BAD_START_FRAMES:
                bad_starts[(seq, oid)] = (set(bad), good)

        seqs = []
        for name in self._select_names(meta):
            info = meta[name]
            img_dir = os.path.join(self.jpeg_path, name)
            anno_dir = os.path.join(base, "Annotations", name)
            frames = sorted(os.path.join(img_dir, fn) for fn in os.listdir(img_dir)
                            if fn.endswith(".jpg"))
            frame_names = [os.path.splitext(os.path.basename(fr))[0] for fr in frames]
            object_ids = list(info["objects"].keys())

            # an object starts at its first labelled frame; one mask per start frame
            init_data: dict = {}
            for oid, obj_info in info["objects"].items():
                obj_frames = list(obj_info["frames"])
                if (name, oid) in bad_starts:
                    bad, good = bad_starts[(name, oid)]
                    obj_frames = [f for f in obj_frames if f not in bad]
                    if obj_frames[0] != good:
                        raise ValueError(f"cleanup 'starts': {name}/{oid} starts at "
                                         f"{obj_frames[0]}, not {good}")
                first = obj_frames[0]
                fidx = frame_names.index(first)
                mask_path = os.path.join(anno_dir, first + ".png")
                entry = init_data.setdefault(fidx, {"object_ids": [], "mask": None})
                entry["object_ids"].append(oid)
                if entry["mask"] is None and os.path.isfile(mask_path):
                    entry["mask"] = imread_indexed(mask_path)

            gt_segs = [os.path.join(anno_dir, fn + ".png")
                       if os.path.isfile(os.path.join(anno_dir, fn + ".png")) else None
                       for fn in frame_names]
            seqs.append(Sequence(name, frames, "yt" + self.version, None,
                                 ground_truth_seg=gt_segs, init_data=init_data,
                                 object_ids=object_ids, multiobj_mode=True))
        return SequenceList(seqs)
