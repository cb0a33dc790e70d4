"""UAV123 (counterpart of pytracking_tpu/evaluation/adapters/uav.py).

Layout: <uav_path>/data_seq/UAV123/<seq>/ and <uav_path>/anno/UAV123/<seq>.txt.
One sequence per annotation file, its frames numbered from 000001; a
sub-sequence (bird1_1) whose folder is absent reads its base's folder
(bird1)."""

from __future__ import annotations

import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root, load_text
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList


class UAVDataset(BaseDataset):
    def __init__(self):
        super().__init__()
        self.base_path = dataset_root(self.env_settings, "uav_path")

    def get_sequence_list(self) -> SequenceList:
        from pytracking_tpu_torch.evaluation.attribute_specs import sequence_attributes

        anno_dir = os.path.join(self.base_path, "anno", "UAV123")
        data_dir = os.path.join(self.base_path, "data_seq", "UAV123")
        seqs = []
        for fn in sorted(os.listdir(anno_dir)):
            if not fn.endswith(".txt"):
                continue
            name = fn[:-4]
            img_dir = os.path.join(data_dir, name)
            if not os.path.isdir(img_dir):
                img_dir = os.path.join(data_dir, name.rsplit("_", 1)[0])
                if not os.path.isdir(img_dir):
                    continue
            gt = np.atleast_2d(load_text(os.path.join(anno_dir, fn)))
            frames = [os.path.join(img_dir, f"{i:06d}.jpg") for i in range(1, len(gt) + 1)]
            seqs.append(Sequence(f"uav_{name}", frames, "uav", gt,
                                 attributes=sequence_attributes("uav", name)))
        return SequenceList(seqs)
