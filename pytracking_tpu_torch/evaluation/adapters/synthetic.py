"""Procedural datasets that need nothing on disk (counterpart of
pytracking_tpu/evaluation/adapters/synthetic.py): a moving coloured square
over a blocky textured background with static distractors. Frames are
`synthetic://<seed>/<frame>/<H>/<W>` URIs that `running._read_image`
renders; they are byte-identical to the JAX package's, since both draw
from numpy's RandomState in the same order."""

from __future__ import annotations

import numpy as np

from pytracking_tpu_torch.evaluation.data import BaseDataset, Sequence, SequenceList


def render_synthetic_frame(seq_seed: int, frame_idx: int, H: int = 240, W: int = 320,
                           num_distractors: int = 2) -> np.ndarray:
    """The frame (H, W, 3) uint8: textured background, distractor blobs and
    the target."""
    rng = np.random.RandomState(seq_seed)
    bg = (rng.rand(H // 8, W // 8, 3) * 60 + 20).astype(np.float32)
    im = np.kron(bg, np.ones((8, 8, 1), np.float32))[:H, :W]

    cy, cx, sz = synthetic_gt_center(seq_seed, frame_idx, H, W)
    color = rng.rand(3) * 155 + 100

    def draw(cy, cx, sz, col):
        y0, y1 = int(max(cy - sz / 2, 0)), int(min(cy + sz / 2, H))
        x0, x1 = int(max(cx - sz / 2, 0)), int(min(cx + sz / 2, W))
        if y1 > y0 and x1 > x0:
            im[y0:y1, x0:x1] = col

    for d in range(num_distractors):     # static: the same in every frame
        dy, dx = rng.rand(2) * [H, W]
        draw(dy, dx, sz * 0.8, rng.rand(3) * 100 + 50)
    draw(cy, cx, sz, color)
    return np.ascontiguousarray(im.astype(np.uint8))


def synthetic_gt_center(seq_seed: int, frame_idx: int, H: int = 240, W: int = 320):
    """The target's centre (cy, cx) and side: a sinusoidal trajectory,
    fixed by (seed, frame)."""
    rng = np.random.RandomState(seq_seed + 1000)
    sz = float(rng.randint(24, 40))
    y0, x0 = H * (0.3 + 0.2 * rng.rand()), W * (0.3 + 0.2 * rng.rand())
    vy, vx = rng.rand(2) * 4 + 1
    cy = y0 + vy * frame_idx + 10 * np.sin(frame_idx / 7.0)
    cx = x0 + vx * frame_idx + 10 * np.cos(frame_idx / 9.0)
    cy = float(np.clip(cy, sz, H - sz))
    cx = float(np.clip(cx, sz, W - sz))
    return cy, cx, sz


def _gt_box(seq_seed: int, t: int, H: int, W: int) -> list:
    cy, cx, sz = synthetic_gt_center(seq_seed, t, H, W)
    return [cx - sz / 2, cy - sz / 2, sz, sz]


class SyntheticDataset(BaseDataset):
    """`num_sequences` sequences of `num_frames` frames."""

    def __init__(self, num_sequences: int = 3, num_frames: int = 20,
                 H: int = 240, W: int = 320):
        super().__init__()
        self.num_sequences = num_sequences
        self.num_frames = num_frames
        self.H, self.W = H, W

    def get_sequence_list(self) -> SequenceList:
        seqs = []
        for s in range(self.num_sequences):
            frames = [f"synthetic://{s}/{t}/{self.H}/{self.W}" for t in range(self.num_frames)]
            gt = [_gt_box(s, t, self.H, self.W) for t in range(self.num_frames)]
            seqs.append(Sequence(f"synthetic_{s:03d}", frames, "synthetic",
                                 np.asarray(gt, np.float32)))
        return SequenceList(seqs)


def load_synthetic_frame(uri: str) -> np.ndarray:
    """Render a synthetic:// frame URI."""
    s, t, H, W = (int(p) for p in uri.split("://", 1)[1].split("/")[:4])
    return render_synthetic_frame(s, t, H, W)


class SyntheticVOSDataset(BaseDataset):
    """Single-object VOS sequences: the same frames, with the target's
    square as the ground-truth mask of object '1'."""

    def __init__(self, num_sequences: int = 2, num_frames: int = 10,
                 H: int = 240, W: int = 320):
        super().__init__()
        self.num_sequences = num_sequences
        self.num_frames = num_frames
        self.H, self.W = H, W

    def _mask(self, seq_seed: int, t: int) -> np.ndarray:
        cy, cx, sz = synthetic_gt_center(seq_seed, t, self.H, self.W)
        m = np.zeros((self.H, self.W), np.uint8)
        y0, y1 = int(max(cy - sz / 2, 0)), int(min(cy + sz / 2, self.H))
        x0, x1 = int(max(cx - sz / 2, 0)), int(min(cx + sz / 2, self.W))
        m[y0:y1, x0:x1] = 1
        return m

    def get_sequence_list(self) -> SequenceList:
        seqs = []
        for s in range(self.num_sequences):
            frames = [f"synthetic://{s}/{t}/{self.H}/{self.W}" for t in range(self.num_frames)]
            gt = [_gt_box(s, t, self.H, self.W) for t in range(self.num_frames)]
            masks = [self._mask(s, t) for t in range(self.num_frames)]
            init_data = {0: {"object_ids": ["1"], "mask": masks[0], "bbox": gt[0]}}
            seqs.append(Sequence(f"synthetic_vos_{s:03d}", frames, "synthetic_vos",
                                 np.asarray(gt, np.float32), ground_truth_seg=masks,
                                 init_data=init_data, object_ids=["1"], multiobj_mode=True))
        return SequenceList(seqs)
