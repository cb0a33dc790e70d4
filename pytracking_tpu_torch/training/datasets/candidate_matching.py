"""KeepTrack's candidate matching training data (counterpart of
pytracking_tpu/training/datasets/candidate_matching.py
`CandidateMatchingDataset`, `CandidateMatchingSampler`): the candidate
file of util_scripts/create_distractor_dataset.py (per sequence, per frame:
candidate (y, x) image coordinates, scores, the frame's state, the
target's candidate and the search area) over the frames of the evaluation
dataset it was made from.

The sampler's samples are the TCM actor's pairs: sample `index` draws its
supervision mode and its usable frame ('target_only' or
'target_with_distractors') from random.Random(index). With `processing` (a
TargetCandidateMatchingProcessing) the frame and its candidates go through
it, with the sampler's own generators (`rng`, `np_rng`; `seed()` reseeds
both, as TrackingSampler's), and its output is renamed to the actor's keys
with the coordinates flipped to (x, y); without it, K slots of the dump's
own candidates, each sample's draws from random.Random(index) and
np.random.RandomState(index) alone."""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image
from pytracking_tpu_torch.training.datasets.base import BaseVideoDataset


class CandidateMatchingDataset(BaseVideoDataset):
    """The sequences of the candidate file `path_to_json` that
    `eval_dataset` (an iterable of evaluation Sequences) holds by name."""

    def __init__(self, eval_dataset, path_to_json: str):
        super().__init__("candidate_matching", "")
        with open(path_to_json) as f:
            self.data = json.load(f)
        self.seq_by_name = {s.name: s for s in eval_dataset}
        self.sequence_list = [n for n in self.data if n in self.seq_by_name]

    def get_frame_states(self) -> Dict[str, List]:
        """{state: [(sequence index, frame index), ...]}."""
        out: Dict[str, List] = {}
        for si, name in enumerate(self.sequence_list):
            for fi, fd in self.data[name].items():
                out.setdefault(fd["state"], []).append((si, int(fi)))
        return out

    def get_frame(self, seq_idx: int, frame_idx: int):
        name = self.sequence_list[seq_idx]
        img = _read_image(self.seq_by_name[name].frames[frame_idx])
        return img, self.data[name][str(frame_idx)]


class CandidateMatchingSampler:
    def __init__(self, dataset: CandidateMatchingDataset, samples_per_epoch: int = 1000,
                 K: int = 8, sup_modes=("self_sup", "partial_sup"), p_sup_modes=(0.5, 0.5),
                 max_jitter: float = 4.0, feat_stride: int = 16, processing=None,
                 score_map_sz=(23, 23), seed: Optional[int] = None):
        self.dataset = dataset
        self.samples_per_epoch = samples_per_epoch
        self.K = K
        self.sup_modes = list(sup_modes)
        self.p_sup_modes = list(p_sup_modes)
        self.max_jitter = max_jitter
        self.feat_stride = feat_stride
        self.processing = processing
        self.score_map_sz = score_map_sz
        states = dataset.get_frame_states()
        self.usable = [p for s in ("target_only", "target_with_distractors")
                       for p in states.get(s, [])]
        if not self.usable:
            raise ValueError(f"the candidate file has no usable frame: states "
                             f"{ {s: len(v) for s, v in states.items()} }")
        self.rng = random.Random()
        self.np_rng = np.random.RandomState()
        self.seed(seed)

    def seed(self, seed: Optional[int]) -> None:
        """Reseed the processing's generators (from the OS's entropy when
        None)."""
        self.rng.seed(seed)
        self.np_rng.seed(seed)

    def __len__(self):
        return self.samples_per_epoch

    def _img_to_tsm(self, coords, sa_box):
        sa = np.asarray(sa_box, np.float32)
        r = np.round((coords[:, 0] - sa[1]) / sa[3] * (self.score_map_sz[0] - 1))
        c = np.round((coords[:, 1] - sa[0]) / sa[2] * (self.score_map_sz[1] - 1))
        return np.stack([np.clip(r, 0, self.score_map_sz[0] - 1),
                         np.clip(c, 0, self.score_map_sz[1] - 1)], 1)

    def _processed_item(self, index: int) -> dict:
        rng = random.Random(index)
        mode = rng.choices(self.sup_modes, self.p_sup_modes)[0]
        si, fi = self.usable[rng.randrange(len(self.usable))]
        img0, fd0 = self.dataset.get_frame(si, fi)
        sa0 = fd0.get("search_area_box") or [0, 0, img0.shape[1], img0.shape[0]]
        c0 = self._img_to_tsm(np.asarray(fd0["coords"], np.float32), sa0)

        if mode == "self_sup":
            data = {"sup_mode": "self_sup", "img": [img0],
                    "search_area_box": [np.asarray(sa0, np.float32)],
                    "target_candidate_coords": [c0],
                    "target_candidate_scores": [np.asarray(fd0["scores"], np.float32)]}
        else:
            name = self.dataset.sequence_list[si]
            nxt = fi + 1 if str(fi + 1) in self.dataset.data[name] else fi
            img1, fd1 = self.dataset.get_frame(si, nxt)
            sa1 = fd1.get("search_area_box") or sa0
            c1 = self._img_to_tsm(np.asarray(fd1["coords"], np.float32), sa1)

            def anno_coord(fd, c):
                m = fd.get("match_idx", -1)
                if m is not None and 0 <= m < len(c):
                    return c[m]
                return c[0] if len(c) else np.zeros(2, np.float32)

            data = {"sup_mode": "partial_sup", "img": [img0, img1],
                    "search_area_box": [np.asarray(sa0, np.float32),
                                        np.asarray(sa1, np.float32)],
                    "target_candidate_coords": [c0, c1],
                    "target_candidate_scores": [np.asarray(fd0["scores"], np.float32),
                                                np.asarray(fd1["scores"], np.float32)],
                    "target_anno_coord": [anno_coord(fd0, c0), anno_coord(fd1, c1)]}
        out = self.processing(data, self.rng, self.np_rng)
        return {
            "img0": out["img_cropped0"], "img1": out["img_cropped1"],
            "tsm_coords0": np.asarray(out["candidate_tsm_coords0"], np.int32),
            "tsm_coords1": np.asarray(out["candidate_tsm_coords1"], np.int32),
            "img_coords0": np.asarray(out["candidate_img_coords0"], np.float32)[:, ::-1].copy(),
            "img_coords1": np.asarray(out["candidate_img_coords1"], np.float32)[:, ::-1].copy(),
            "scores0": np.asarray(out["candidate_scores0"], np.float32),
            "scores1": np.asarray(out["candidate_scores1"], np.float32),
            "gt_assignment": np.asarray(out["gt_assignment"], np.float32),
            "gt_matches0": np.asarray(out["gt_matches0"], np.int32),
            "gt_matches1": np.asarray(out["gt_matches1"], np.int32),
        }

    def _slots(self, fd):
        coords = np.zeros((self.K, 2), np.float32)
        scores = np.zeros(self.K, np.float32)
        n = min(len(fd["scores"]), self.K)
        coords[:n] = np.asarray(fd["coords"], np.float32)[:n]
        scores[:n] = np.asarray(fd["scores"], np.float32)[:n]
        return coords, scores, n

    def __getitem__(self, index: int) -> dict:
        if self.processing is not None:
            return self._processed_item(index)
        rng = random.Random(index)
        nprng = np.random.RandomState(index)
        mode = rng.choices(self.sup_modes, self.p_sup_modes)[0]
        si, fi = self.usable[rng.randrange(len(self.usable))]
        img0, fd0 = self.dataset.get_frame(si, fi)
        img1, fd1 = img0, fd0
        if mode != "self_sup" and str(fi + 1) in self.dataset.data[self.dataset.sequence_list[si]]:
            img1, fd1 = self.dataset.get_frame(si, fi + 1)

        c0, s0, n0 = self._slots(fd0)
        c1, s1, n1 = self._slots(fd1)
        if mode == "self_sup":
            c1 = c0 + nprng.uniform(-self.max_jitter, self.max_jitter, c0.shape)
            s1 = np.clip(s0 + nprng.uniform(-0.05, 0.05, s0.shape), 0, None)
            n1 = n0

        K = self.K
        gt_assignment = np.zeros((K, K), np.float32)
        gt_matches0 = np.full(K, -2, np.int32)
        gt_matches1 = np.full(K, -2, np.int32)
        if mode == "self_sup":
            for i in range(n0):
                gt_assignment[i, i] = 1.0
                gt_matches0[i] = i
                gt_matches1[i] = i
        else:
            m0, m1 = fd0.get("match_idx", -1), fd1.get("match_idx", -1)
            gt_matches0[:n0] = -1
            gt_matches1[:n1] = -1
            if 0 <= m0 < K and 0 <= m1 < K:
                gt_assignment[m0, m1] = 1.0
                gt_matches0[m0] = m1
                gt_matches1[m1] = m0

        fs = float(self.feat_stride)
        return {
            "img0": np.asarray(img0, np.float32), "img1": np.asarray(img1, np.float32),
            "tsm_coords0": (c0 / fs).astype(np.int32), "tsm_coords1": (c1 / fs).astype(np.int32),
            "img_coords0": c0[:, ::-1].copy(), "img_coords1": c1[:, ::-1].copy(),
            "scores0": s0, "scores1": s1,
            "gt_assignment": gt_assignment,
            "gt_matches0": gt_matches0, "gt_matches1": gt_matches1,
        }
