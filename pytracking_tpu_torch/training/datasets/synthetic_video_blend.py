"""Videos made by pasting a segmented foreground over a background image
(counterpart of pytracking_tpu/training/datasets/synthetic_video_blend.py
`SyntheticVideoBlend`): sequence i pastes foreground i's box crop through
its mask over one background drawn by np.random.RandomState(seed + 7919 i),
at a centre that starts in the middle 40% of the frame and walks by at most
max_shift * 0.2 of its size per frame (RandomState(seed + i)), kept within
15-85%. The boxes and masks are those of the pasted pixels."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pytracking_tpu_torch.training.datasets.base import BaseVideoDataset


class SyntheticVideoBlend(BaseVideoDataset):
    def __init__(self, foreground_image_dataset, background_image_dataset, seq_len: int = 10,
                 max_shift: float = 0.3, seed: int = 0):
        super().__init__(foreground_image_dataset.get_name() + "_syn_vid_blend",
                         foreground_image_dataset.root)
        self.fg = foreground_image_dataset
        self.bg = background_image_dataset
        self.seq_len = seq_len
        self.max_shift = max_shift
        self.seed = seed
        self.sequence_list = list(range(self.fg.get_num_sequences()))

    def has_segmentation_info(self):
        return True

    def _paste_locs(self, seq_id: int, bg_shape):
        rng = np.random.RandomState(self.seed + seq_id)
        H, W = bg_shape[:2]
        cy = rng.uniform(0.3, 0.7) * H
        cx = rng.uniform(0.3, 0.7) * W
        locs = []
        for _ in range(self.seq_len):
            locs.append((cy, cx))
            cy = np.clip(cy + rng.uniform(-1, 1) * self.max_shift * H * 0.2, 0.15 * H, 0.85 * H)
            cx = np.clip(cx + rng.uniform(-1, 1) * self.max_shift * W * 0.2, 0.15 * W, 0.85 * W)
        return locs

    @staticmethod
    def _paste(fg_im, fg_box, fg_mask, bg_im, loc):
        """(image, mask): fg's box crop blended through its mask over bg,
        centred at loc and clipped to bg."""
        x, y, w, h = [int(v) for v in fg_box]
        w, h = max(w, 1), max(h, 1)
        crop = fg_im[y:y + h, x:x + w]
        mcrop = fg_mask[y:y + h, x:x + w]
        H, W = bg_im.shape[:2]
        y1 = int(loc[0] - h / 2)
        x1 = int(loc[1] - w / 2)
        y1c, x1c = max(y1, 0), max(x1, 0)
        y2c, x2c = min(y1 + h, H), min(x1 + w, W)
        out = bg_im.astype(np.float32).copy()
        mask_out = np.zeros((H, W), np.float32)
        if y2c > y1c and x2c > x1c:
            cs = crop[y1c - y1:y2c - y1, x1c - x1:x2c - x1]
            ms = mcrop[y1c - y1:y2c - y1, x1c - x1:x2c - x1]
            region = out[y1c:y2c, x1c:x2c]
            out[y1c:y2c, x1c:x2c] = ms[..., None] * cs + (1 - ms[..., None]) * region
            mask_out[y1c:y2c, x1c:x2c] = ms
        return out, mask_out

    def get_sequence_info(self, seq_id: int):
        """The foreground's box at every frame (the pasted boxes come with
        get_frames)."""
        info = self.fg.get_sequence_info(self.sequence_list[seq_id])
        fg_box = np.asarray(info["bbox"]).reshape(-1, 4)[0]
        bbox = np.tile(fg_box, (self.seq_len, 1)).astype(np.float32)
        valid = np.ones(self.seq_len, bool)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        fg_frames, fg_anno, meta = self.fg.get_frames(self.sequence_list[seq_id], [0])
        fg_im = np.asarray(fg_frames[0], np.float32)
        fg_box = np.asarray(fg_anno["bbox"][0], np.float32)
        if "mask" in fg_anno:
            fg_mask = np.asarray(fg_anno["mask"][0], np.float32)
        else:
            fg_mask = np.zeros(fg_im.shape[:2], np.float32)
            x, y, w, h = [int(v) for v in fg_box]
            fg_mask[y:y + max(h, 1), x:x + max(w, 1)] = 1.0

        rng = np.random.RandomState(self.seed + 7919 * seq_id)
        bg_frames, _, _ = self.bg.get_frames(rng.randint(0, self.bg.get_num_sequences()), [0])
        bg_im = np.asarray(bg_frames[0], np.float32)

        locs = self._paste_locs(seq_id, bg_im.shape)
        frames, masks, boxes = [], [], []
        for t in frame_ids:
            im, m = self._paste(fg_im, fg_box, fg_mask, bg_im, locs[t])
            frames.append(im)
            masks.append(m)
            ys, xs = np.nonzero(m)
            if len(ys):
                boxes.append(np.asarray([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                                         ys.max() - ys.min() + 1], np.float32))
            else:
                boxes.append(np.zeros(4, np.float32))
        frame_anno = {"bbox": boxes, "mask": masks,
                      "valid": [b[2] > 0 for b in boxes],
                      "visible": [b[2] > 0 for b in boxes]}
        return frames, frame_anno, meta
