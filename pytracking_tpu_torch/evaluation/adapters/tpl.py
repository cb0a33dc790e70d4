"""Temple Color 128 (counterpart of pytracking_tpu/evaluation/adapters/tpl.py).

Layout: <tpl_path>/<seq>/{img/, <seq>_gt.txt, <seq>_frames.txt (first and
last frame)}. Sequences are named tpl_<seq>; `exclude_otb` leaves out the
37 that OTB-100 also holds."""

from __future__ import annotations

import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root, load_text
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList

_OTB_OVERLAP = {
    "tpl_Basketball", "tpl_Bolt", "tpl_Boy", "tpl_CarDark", "tpl_CarScale",
    "tpl_Coke", "tpl_Couple", "tpl_Crossing", "tpl_David", "tpl_David3",
    "tpl_Deer", "tpl_Diving", "tpl_Doll", "tpl_Girl", "tpl_Girl2", "tpl_Gym",
    "tpl_Ironman", "tpl_Jogging", "tpl_Lemming", "tpl_Liquor", "tpl_Matrix",
    "tpl_MountainBike", "tpl_Panda", "tpl_Shaking", "tpl_Singer1", "tpl_Singer2",
    "tpl_Skating1", "tpl_Skating2", "tpl_Skiing", "tpl_Soccer", "tpl_Subway",
    "tpl_Tiger1", "tpl_Tiger2", "tpl_Trellis", "tpl_Walking", "tpl_Walking2",
    "tpl_Woman"}


class TPLDataset(BaseDataset):
    def __init__(self, exclude_otb: bool = False):
        super().__init__()
        self.base_path = dataset_root(self.env_settings, "tpl_path")
        self.exclude_otb = exclude_otb

    def get_sequence_list(self) -> SequenceList:
        seqs = []
        for name in sorted(os.listdir(self.base_path)):
            seq_dir = os.path.join(self.base_path, name)
            img_dir = os.path.join(seq_dir, "img")
            gt_path = os.path.join(seq_dir, f"{name}_gt.txt")
            if not (os.path.isdir(img_dir) and os.path.isfile(gt_path)):
                continue
            seq_name = f"tpl_{name}"
            if self.exclude_otb and seq_name in _OTB_OVERLAP:
                continue
            gt = np.atleast_2d(load_text(gt_path))
            frames_file = os.path.join(seq_dir, f"{name}_frames.txt")
            if os.path.isfile(frames_file):
                rng = load_text(frames_file).reshape(-1).astype(int)
                ids = range(int(rng[0]), int(rng[1]) + 1)
            else:
                ids = range(1, len(gt) + 1)
            frames = [os.path.join(img_dir, f"{i:04d}.jpg") for i in ids]
            n = min(len(frames), len(gt))
            seqs.append(Sequence(seq_name, frames[:n], "tpl", gt[:n]))
        return SequenceList(seqs)
