"""DAVIS 2016 / 2017 (counterpart of
pytracking_tpu/evaluation/adapters/davis.py).

Layout: <davis_dir>/JPEGImages/480p/<seq>/*.jpg, Annotations/480p/<seq>/*.png
(indexed masks, one label per object) and ImageSets/<year>/<split>.txt.
Every object starts at frame 0 from the first mask."""

from __future__ import annotations

import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList


class DavisDataset(BaseDataset):
    def __init__(self, version: str = "2017", split: str = "val"):
        super().__init__()
        self.base_path = dataset_root(self.env_settings, "davis_dir")
        self.version = version
        self.split = split

    def get_sequence_list(self) -> SequenceList:
        from pytracking_tpu_torch.utils.png_io import imread_indexed

        with open(os.path.join(self.base_path, "ImageSets", self.version, f"{self.split}.txt")) as f:
            seq_names = [s.strip() for s in f if s.strip()]

        seqs = []
        for name in seq_names:
            img_dir = os.path.join(self.base_path, "JPEGImages", "480p", name)
            anno_dir = os.path.join(self.base_path, "Annotations", "480p", name)
            frames = sorted(os.path.join(img_dir, fn) for fn in os.listdir(img_dir)
                            if fn.endswith(".jpg"))
            annos = [os.path.join(anno_dir, os.path.splitext(os.path.basename(fr))[0] + ".png")
                     for fr in frames]
            init_mask = imread_indexed(annos[0])
            object_ids = [str(o) for o in np.unique(init_mask) if o != 0]
            gt_segs = [a if os.path.isfile(a) else None for a in annos]
            init_data = {0: {"object_ids": object_ids, "mask": init_mask}}
            seqs.append(Sequence(name, frames, "davis", None, ground_truth_seg=gt_segs,
                                 init_data=init_data, object_ids=object_ids,
                                 multiobj_mode=True))
        return SequenceList(seqs)
