"""TrackingNet (counterpart of
pytracking_tpu/evaluation/adapters/trackingnet.py).

Layout: <trackingnet_path>/<split>/{frames/<seq>/<i>.jpg, anno/<seq>.txt},
frames numbered from 0. `vos_mode=True` adds each sequence's first-frame
mask, <trackingnet_mask_path>/<seq>/0.png."""

from __future__ import annotations

import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root, load_text
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList


class TrackingNetDataset(BaseDataset):
    def __init__(self, split: str = "TEST", load_frames: bool = True, vos_mode: bool = False):
        super().__init__()
        self.base_path = os.path.join(dataset_root(self.env_settings, "trackingnet_path"),
                                      split)
        self.load_frames = load_frames
        self.vos_mode = vos_mode
        self.mask_path = self.env_settings.trackingnet_mask_path if vos_mode else None

    def get_sequence_list(self) -> SequenceList:
        from pytracking_tpu_torch.evaluation.adapters.lasot import load_first_frame_mask

        base = self.base_path
        anno_dir = os.path.join(base, "anno")
        frames_dir = os.path.join(base, "frames")
        seqs = []
        for fn in sorted(os.listdir(anno_dir)):
            if not fn.endswith(".txt"):
                continue
            name = fn[:-4]
            gt = np.atleast_2d(load_text(os.path.join(anno_dir, fn)))
            seq_frames_dir = os.path.join(frames_dir, name)
            frames = []
            if self.load_frames:
                n = len([f for f in os.listdir(seq_frames_dir) if f.endswith(".jpg")])
                frames = [os.path.join(seq_frames_dir, f"{i}.jpg") for i in range(n)]
            masks = None
            if self.vos_mode and frames:
                masks = [load_first_frame_mask(self.mask_path, name, "0")]
            seqs.append(Sequence(name, frames, "trackingnet", gt, ground_truth_seg=masks))
        return SequenceList(seqs)
