"""MobiFace (counterpart of pytracking_tpu/evaluation/adapters/mobiface.py).

Layout: <mobiface_path>/{train,test}.meta.csv (a header, then one sequence
name per row), <mobiface_path>/<split>/<seq>/*.jpg (or *.png) and
<mobiface_path>/<split>/<seq>.annot.csv (a header, then frame, x, y, w, h).
Splits 'train', 'test' and 'all'."""

from __future__ import annotations

import csv
import glob
import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList


def _read_meta(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return [r[0] for r in rows[1:]] if rows else []


class MobifaceDataset(BaseDataset):
    def __init__(self, split: str = "all"):
        super().__init__()
        self.base_path = dataset_root(self.env_settings, "mobiface_path")
        train = _read_meta(os.path.join(self.base_path, "train.meta.csv"))
        test = _read_meta(os.path.join(self.base_path, "test.meta.csv"))
        if split == "train":
            names = [(n, "train") for n in train]
        elif split == "test":
            names = [(n, "test") for n in test]
        elif split == "all":
            names = [(n, "train") for n in train] + [(n, "test") for n in test]
        else:
            raise ValueError(f"Unknown MobiFace split: {split}")
        self.entries = sorted(names)

    def get_sequence_list(self) -> SequenceList:
        return SequenceList([self._construct_sequence(n, sub) for n, sub in self.entries])

    def _construct_sequence(self, name, subdir) -> Sequence:
        seq_dir = os.path.join(self.base_path, subdir, name)
        frames = sorted(glob.glob(seq_dir + "/*.jpg")) or sorted(glob.glob(seq_dir + "/*.png"))
        anno = np.loadtxt(seq_dir + ".annot.csv", delimiter=",", skiprows=1, dtype=int)[:, 1:]
        return Sequence(name, frames, "mobiface", anno.reshape(-1, 4))

    def __len__(self):
        return len(self.entries)
