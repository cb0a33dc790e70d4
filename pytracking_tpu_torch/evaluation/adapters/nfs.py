"""Need for Speed, its 30 fps split (counterpart of
pytracking_tpu/evaluation/adapters/nfs.py). Layout:
<nfs_path>/<seq>/30/<seq>/<frames>.jpg with the annotation
<nfs_path>/<seq>/30/<seq>.txt, whose columns 1-4 are x1 y1 x2 y2."""

from __future__ import annotations

import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root, load_text
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList


class NFSDataset(BaseDataset):
    def __init__(self):
        super().__init__()
        self.base_path = dataset_root(self.env_settings, "nfs_path")

    def get_sequence_list(self) -> SequenceList:
        seqs = []
        for name in sorted(os.listdir(self.base_path)):
            d30 = os.path.join(self.base_path, name, "30")
            if not os.path.isdir(d30):
                continue
            anno_path = os.path.join(d30, name + ".txt")
            img_dir = os.path.join(d30, name)
            if not (os.path.isfile(anno_path) and os.path.isdir(img_dir)):
                continue
            raw = np.atleast_2d(load_text(anno_path, delimiter=["\t", " "]))
            xyxy = raw[:, 1:5].astype(np.float64)
            gt = np.stack([xyxy[:, 0], xyxy[:, 1], xyxy[:, 2] - xyxy[:, 0],
                           xyxy[:, 3] - xyxy[:, 1]], axis=1)
            frames = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                            if f.endswith(".jpg"))
            n = min(len(frames), len(gt))
            seqs.append(Sequence(f"nfs_{name}", frames[:n], "nfs", gt[:n]))
        return SequenceList(seqs)
