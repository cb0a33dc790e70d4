"""AVisT (counterpart of pytracking_tpu/evaluation/adapters/avist.py).

Layout: <avist_path>/{sequences/<seq>/, anno/<seq>.txt, full_occlusion/<seq>.txt,
out_of_view/<seq>.txt}. Each sequence's attributes are its scenario codes
from `avist_scenarios.json` (dataset_attribute_specs/, or the attribute
specs path)."""

from __future__ import annotations

import json
import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root, load_text
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList


def load_scenarios() -> dict:
    """Sequence name -> short scenario codes, with the short and long
    scenario names under 'att_name_short' / 'att_name_long'; {} without
    the file."""
    from pytracking_tpu_torch.evaluation.attribute_specs import spec_path

    path = spec_path("avist_scenarios")
    if path is None:
        return {}
    with open(path) as f:
        return json.load(f)


class AVisTDataset(BaseDataset):
    def __init__(self):
        super().__init__()
        self.base_path = dataset_root(self.env_settings, "avist_path")
        self._scenarios = load_scenarios()

    def get_sequence_list(self) -> SequenceList:
        anno_dir = os.path.join(self.base_path, "anno")
        seqs = []
        for fn in sorted(os.listdir(anno_dir)):
            if not fn.endswith(".txt"):
                continue
            name = fn[:-4]
            gt = np.atleast_2d(load_text(os.path.join(anno_dir, fn)))
            img_dir = os.path.join(self.base_path, "sequences", name)
            if not os.path.isdir(img_dir):
                continue
            frames = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                            if f.lower().endswith((".jpg", ".png")))
            target_visible = None
            occ_p = os.path.join(self.base_path, "full_occlusion", name + ".txt")
            oov_p = os.path.join(self.base_path, "out_of_view", name + ".txt")
            if os.path.isfile(occ_p) and os.path.isfile(oov_p):
                occ = load_text(occ_p).reshape(-1)
                oov = load_text(oov_p).reshape(-1)
                n = min(len(occ), len(oov), len(gt))
                target_visible = (occ[:n] == 0) & (oov[:n] == 0)
            n = min(len(frames), len(gt))
            seqs.append(Sequence(name, frames[:n], "avist", gt[:n],
                                 target_visible=target_visible,
                                 attributes=self._scenarios.get(name)))
        return SequenceList(seqs)
