"""OTB-100 (counterpart of pytracking_tpu/evaluation/adapters/otb.py).

Layout: <otb_path>/<SeqName>/{img/, groundtruth_rect.txt}. The directory is
scanned; the benchmark's irregular sequences are listed here: those whose
frame range is not the whole image folder (`_START_END`) and those with
two targets or another annotation file (`_MULTI_GT`, one sequence
`<name>-<k>` per file).
"""

from __future__ import annotations

import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root, load_text
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList

# first and last frame of the sequences that use part of their image folder
_START_END = {"David": (300, 770), "Football1": (1, 74), "Freeman3": (1, 460),
              "Freeman4": (1, 283), "Diving": (1, 215), "Tiger1": (6, 354)}
_MULTI_GT = {"Jogging": ["groundtruth_rect.1.txt", "groundtruth_rect.2.txt"],
             "Skating2": ["groundtruth_rect.1.txt", "groundtruth_rect.2.txt"],
             "Human4": ["groundtruth_rect.2.txt"]}


class OTBDataset(BaseDataset):
    def __init__(self, attribute=None):
        super().__init__()
        self.base_path = dataset_root(self.env_settings, "otb_path")
        self.attribute = attribute

    def get_attribute_names(self, mode="short"):
        from pytracking_tpu_torch.evaluation.attribute_specs import attribute_names
        return attribute_names("otb", mode)

    def get_sequence_list(self) -> SequenceList:
        from pytracking_tpu_torch.evaluation.attribute_specs import (
            filter_names_by_attribute, sequence_attributes)
        seqs = []
        for name in sorted(os.listdir(self.base_path)):
            seq_dir = os.path.join(self.base_path, name)
            img_dir = os.path.join(seq_dir, "img")
            if not os.path.isdir(img_dir):
                continue
            gt_files = _MULTI_GT.get(name, ["groundtruth_rect.txt"])
            for i, gt_file in enumerate(gt_files):
                gt_path = os.path.join(seq_dir, gt_file)
                if not os.path.isfile(gt_path):
                    continue
                gt = np.atleast_2d(load_text(gt_path, delimiter=[",", "\t"]))
                start, end = _START_END.get(name, (1, None))
                frames = [f for f in sorted(os.listdir(img_dir))
                          if f.lower().endswith((".jpg", ".png"))]
                if end is None:
                    end = start + len(gt) - 1
                sel = [os.path.join(img_dir, f"{k:04d}.jpg") for k in range(start, end + 1)]
                if not os.path.isfile(sel[0]):
                    sel = [os.path.join(img_dir, f) for f in frames[:len(gt)]]
                n = min(len(sel), len(gt))
                seq_name = name if len(gt_files) == 1 else f"{name}-{i + 1}"
                seqs.append(Sequence(seq_name, sel[:n], "otb", gt[:n],
                                     attributes=sequence_attributes("otb", name)))
        if self.attribute is not None:
            keep = set(filter_names_by_attribute(
                "otb", [s.name.split("-")[0] for s in seqs], self.attribute))
            seqs = [s for s in seqs if s.name.split("-")[0] in keep]
        return SequenceList(seqs)
