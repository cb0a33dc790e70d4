"""Training dataset API (counterpart of
pytracking_tpu/training/datasets/base.py). Frames are numpy HWC RGB; a
sequence's info is a dict of per-frame arrays {'bbox': (L, 4), 'valid':
(L,), 'visible': (L,)}."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class BaseVideoDataset:
    def __init__(self, name: str, root: str):
        self.name = name
        self.root = root
        self.sequence_list: List = []

    def __len__(self):
        return self.get_num_sequences()

    def get_name(self) -> str:
        return self.name

    def get_num_sequences(self) -> int:
        return len(self.sequence_list)

    def is_video_sequence(self) -> bool:
        return True

    def has_class_info(self) -> bool:
        return False

    def has_occlusion_info(self) -> bool:
        return False

    def get_sequence_info(self, seq_id: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def get_frames(self, seq_id: int, frame_ids: List[int],
                   anno: Optional[dict] = None
                   ) -> Tuple[List[np.ndarray], dict, dict]:
        """Returns (frames, per-frame anno dict of lists, object meta)."""
        raise NotImplementedError


class BaseImageDataset(BaseVideoDataset):
    def is_video_sequence(self) -> bool:
        return False
