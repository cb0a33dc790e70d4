"""VOT short-term (counterpart of pytracking_tpu/evaluation/adapters/vot.py).

Layout: <vot_path>/<seq>/{color/*.jpg or *.jpg, groundtruth.txt}, the
sequences in list.txt where there is one, else every folder. Polygon
annotations (8 values per frame) become axis-aligned boxes of the same
centre and area (`convert_vot_anno_to_rect`, 'preserve_area'). `year`
(18 or 22) names the challenge; both read the same layout."""

from __future__ import annotations

import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root, load_text
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList
from pytracking_tpu_torch.utils.convert_vot_anno import convert_vot_anno_to_rect


class VOTDataset(BaseDataset):
    def __init__(self, year: int = 18):
        super().__init__()
        self.base_path = dataset_root(self.env_settings, "vot_path")
        self.year = year

    def get_sequence_list(self) -> SequenceList:
        list_file = os.path.join(self.base_path, "list.txt")
        if os.path.isfile(list_file):
            with open(list_file) as f:
                names = [line.strip() for line in f if line.strip()]
        else:
            names = sorted(d for d in os.listdir(self.base_path) if os.path.isdir(os.path.join(self.base_path, d)))
        seqs = []
        for name in names:
            seq_dir = os.path.join(self.base_path, name)
            gt_path = os.path.join(seq_dir, "groundtruth.txt")
            if not os.path.isfile(gt_path):
                continue
            raw = np.atleast_2d(load_text(gt_path))
            if raw.shape[1] == 8:
                gt = np.stack([convert_vot_anno_to_rect(r, "preserve_area") for r in raw])
            else:
                gt = raw
            img_dir = os.path.join(seq_dir, "color")
            if not os.path.isdir(img_dir):
                img_dir = seq_dir
            frames = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                            if f.endswith(".jpg"))
            n = min(len(frames), len(gt))
            seqs.append(Sequence(name, frames[:n], "vot", gt[:n]))
        return SequenceList(seqs)
