"""GOT-10k (counterpart of pytracking_tpu/evaluation/adapters/got10k.py).

Layout: <got10k_path>/{test,val}/GOT-10k_*/{*.jpg, groundtruth.txt}, the
sequences in the split's list.txt where there is one, else every folder.
The split 'ltrval' reads the val folder. `vos_mode=True` adds each
sequence's first-frame mask, <got10k_mask_path>/<seq>/<first frame>.png.
"""

from __future__ import annotations

import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters._util import dataset_root, load_text
from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList


class GOT10KDataset(BaseDataset):
    def __init__(self, split: str = "test", vos_mode: bool = False):
        super().__init__()
        self.split = "val" if split == "ltrval" else split
        self.base_path = os.path.join(dataset_root(self.env_settings, "got10k_path"),
                                      self.split)
        self.vos_mode = vos_mode
        self.mask_path = self.env_settings.got10k_mask_path if vos_mode else None

    def get_sequence_list(self) -> SequenceList:
        from pytracking_tpu_torch.evaluation.adapters.lasot import load_first_frame_mask

        base = self.base_path
        list_file = os.path.join(base, "list.txt")
        if os.path.isfile(list_file):
            with open(list_file) as f:
                names = [line.strip() for line in f if line.strip()]
        else:
            names = sorted(d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d)))
        seqs = []
        for name in names:
            seq_dir = os.path.join(base, name)
            gt = np.atleast_2d(load_text(os.path.join(seq_dir, "groundtruth.txt")))
            frames = sorted(os.path.join(seq_dir, fn) for fn in os.listdir(seq_dir)
                            if fn.endswith(".jpg"))
            masks = None
            if self.vos_mode:
                first = os.path.splitext(os.path.basename(frames[0]))[0]
                masks = [load_first_frame_mask(self.mask_path, name, first)]
            seqs.append(Sequence(name, frames, "got10k", gt, ground_truth_seg=masks))
        return SequenceList(seqs)
