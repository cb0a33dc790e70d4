"""LaSOT (counterpart of pytracking_tpu/evaluation/adapters/lasot.py).

Layout: <lasot_path>/<class>-<id>/{img/, groundtruth.txt, full_occlusion.txt,
out_of_view.txt}, or the class-folder layout <lasot_path>/<class>/<class>-<id>/.
The test split is the set of sequences under the path: point `lasot_path`
at the extracted test set.

`vos_mode=True` adds each sequence's first-frame mask,
<lasot_mask_path>/<seq>/00000001.png (registry name `lasotvos`).
`LaSOTTrainSequencesDataset` keeps the training split's names of the
upstream `lasot_train_split.txt` data spec where one is found, else every
sequence on disk.
"""

from __future__ import annotations

import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root, load_text
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList


def load_first_frame_mask(mask_path: str, seq_name: str, frame_name: str):
    """<mask_path>/<seq>/<frame>.png as a label array; None where no mask
    path is set or the file is absent (reported)."""
    if not mask_path:
        return None
    path = os.path.join(mask_path, seq_name, frame_name + ".png")
    if not os.path.isfile(path):
        print("Error: Could not read:", path, flush=True)
        return None
    from pytracking_tpu_torch.utils.png_io import imread_indexed
    return imread_indexed(path)


class LaSOTDataset(BaseDataset):
    path_setting = "lasot_path"
    dataset_name = "lasot"

    def __init__(self, vos_mode: bool = False, attribute=None):
        super().__init__()
        self.base_path = dataset_root(self.env_settings, self.path_setting)
        self.vos_mode = vos_mode
        self.attribute = attribute
        self.mask_path = self.env_settings.lasot_mask_path if vos_mode else None

    def get_attribute_names(self, mode="short"):
        from pytracking_tpu_torch.evaluation.attribute_specs import attribute_names
        return attribute_names("lasot", mode)

    def _seq_dirs(self):
        out = []
        for d in sorted(os.listdir(self.base_path)):
            p = os.path.join(self.base_path, d)
            if os.path.isdir(os.path.join(p, "img")):
                out.append((d, p))
            elif os.path.isdir(p):
                for s in sorted(os.listdir(p)):
                    sp = os.path.join(p, s)
                    if os.path.isdir(os.path.join(sp, "img")):
                        out.append((s, sp))
        return out

    def _filter_names(self, named_dirs):
        return named_dirs

    def get_sequence_list(self) -> SequenceList:
        from pytracking_tpu_torch.evaluation.attribute_specs import (
            filter_names_by_attribute, sequence_attributes)
        named_dirs = self._filter_names(self._seq_dirs())
        if self.attribute is not None:
            keep = set(filter_names_by_attribute(
                "lasot", [n for n, _ in named_dirs], self.attribute))
            named_dirs = [(n, p) for n, p in named_dirs if n in keep]
        seqs = []
        for name, seq_dir in named_dirs:
            gt = np.atleast_2d(load_text(os.path.join(seq_dir, "groundtruth.txt")))
            occ_path = os.path.join(seq_dir, "full_occlusion.txt")
            oov_path = os.path.join(seq_dir, "out_of_view.txt")
            target_visible = None
            if os.path.isfile(occ_path) and os.path.isfile(oov_path):
                occ = load_text(occ_path).reshape(-1)
                oov = load_text(oov_path).reshape(-1)
                n = min(len(occ), len(oov), len(gt))
                target_visible = (occ[:n] == 0) & (oov[:n] == 0)
            frames = [os.path.join(seq_dir, "img", f"{i:08d}.jpg")
                      for i in range(1, len(gt) + 1)]
            masks = None
            if self.vos_mode:
                masks = [load_first_frame_mask(self.mask_path, name, "00000001")]
            seqs.append(Sequence(name, frames, self.dataset_name, gt,
                                 target_visible=target_visible, ground_truth_seg=masks,
                                 attributes=sequence_attributes("lasot", name)))
        return SequenceList(seqs)


class LaSOTTrainSequencesDataset(LaSOTDataset):
    """LaSOT's training split (registry name `lasot_train`)."""

    def _filter_names(self, named_dirs):
        from pytracking_tpu_torch.training.datasets.data_specs import load_str_spec
        try:
            names = set(load_str_spec("lasot_train_split.txt"))
        except FileNotFoundError:
            return named_dirs
        return [(n, p) for n, p in named_dirs if n in names]
