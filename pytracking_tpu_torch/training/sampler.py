"""Training sample sampler: dataset -> sequence -> train and test frames
(counterpart of pytracking_tpu/training/sampler.py `TrackingSampler`,
`DiMPSampler`): causal or interval frame sampling within max_gap under the
visibility constraints.

The sampler owns its random generators, a `random.Random` and a
`np.random.RandomState` (`seed()` reseeds both), and passes them to the
processing. Drawn in the same order, they give what the JAX sampler's
draws from the global `random` / `np.random` give after `random.seed(s)` /
`np.random.seed(s)`. With a loader of several worker threads, the threads
share the generators, so which sample gets which draws depends on the
threads' order, as in the JAX pipeline.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


class TrackingSampler:
    def __init__(self, datasets: List, p_datasets: Optional[List[float]] = None,
                 samples_per_epoch: int = 1000, max_gap: int = 30,
                 num_test_frames: int = 1, num_train_frames: int = 3,
                 processing=None, frame_sample_mode: str = "causal",
                 seed: Optional[int] = None):
        self.datasets = datasets
        p = p_datasets or [len(d) for d in datasets]
        s = sum(p)
        self.p_datasets = [x / s for x in p]
        self.samples_per_epoch = samples_per_epoch
        self.max_gap = max_gap
        self.num_test_frames = num_test_frames
        self.num_train_frames = num_train_frames
        self.processing = processing
        self.frame_sample_mode = frame_sample_mode
        self.rng = random.Random()
        self.np_rng = np.random.RandomState()
        self.seed(seed)

    def seed(self, seed: Optional[int]) -> None:
        """Reseed both generators (from the OS's entropy when None)."""
        self.rng.seed(seed)
        self.np_rng.seed(seed)

    def __len__(self):
        return self.samples_per_epoch

    def _sample_visible_ids(self, visible: np.ndarray, num_ids: int = 1,
                            min_id: Optional[int] = None,
                            max_id: Optional[int] = None) -> Optional[List[int]]:
        if num_ids == 0:
            return []
        min_id = max(0, min_id or 0)
        max_id = len(visible) if max_id is None or max_id > len(visible) else max_id
        valid = [i for i in range(min_id, max_id) if visible[i]]
        if not valid:
            return None
        return self.rng.choices(valid, k=num_ids)

    def __getitem__(self, index: int) -> dict:
        """A sequence with enough visible frames, then train and test frame
        ids (causal: the test frames after the first train frame, within
        max_gap), processed. `index` is not used: every call draws anew."""
        rng = self.rng
        dataset = rng.choices(self.datasets, self.p_datasets)[0]
        is_video = dataset.is_video_sequence()

        enough_visible = False
        for _ in range(100):
            seq_id = rng.randint(0, dataset.get_num_sequences() - 1)
            info = dataset.get_sequence_info(seq_id)
            visible = np.asarray(info["visible"])
            enough_visible = visible.sum() > 2 * (self.num_test_frames +
                                                  self.num_train_frames) and \
                len(visible) >= 20
            if enough_visible or not is_video:
                break

        if is_video:
            train_ids = test_ids = None
            gap_increase = 0
            while test_ids is None:
                if self.frame_sample_mode == "interval":
                    base = self._sample_visible_ids(visible)
                    extra = self._sample_visible_ids(
                        visible, self.num_train_frames - 1,
                        base[0] - self.max_gap - gap_increase,
                        base[0] + self.max_gap + gap_increase)
                    if extra is None:
                        gap_increase += 5
                        continue
                    train_ids = base + extra
                    test_ids = self._sample_visible_ids(
                        visible, self.num_test_frames,
                        min(train_ids) - self.max_gap - gap_increase,
                        max(train_ids) + self.max_gap + gap_increase)
                    gap_increase += 5
                else:  # causal
                    base = self._sample_visible_ids(
                        visible, 1, self.num_train_frames - 1,
                        len(visible) - self.num_test_frames)
                    if base is None:
                        gap_increase += 5
                        if gap_increase > 1000:
                            raise RuntimeError("Cannot sample frames")
                        continue
                    prev = self._sample_visible_ids(
                        visible, self.num_train_frames - 1,
                        base[0] - self.max_gap - gap_increase, base[0])
                    if prev is None:
                        gap_increase += 5
                        continue
                    train_ids = base + prev
                    test_ids = self._sample_visible_ids(
                        visible, self.num_test_frames, train_ids[0] + 1,
                        train_ids[0] + self.max_gap + gap_increase)
                    gap_increase += 5
        else:
            seq_len = len(visible)
            train_ids = [rng.randint(0, seq_len - 1) for _ in range(self.num_train_frames)]
            test_ids = [rng.randint(0, seq_len - 1) for _ in range(self.num_test_frames)]

        train_frames, train_anno, _ = dataset.get_frames(seq_id, train_ids, info)
        test_frames, test_anno, _ = dataset.get_frames(seq_id, test_ids, info)

        data = {"train_images": train_frames, "train_anno": train_anno["bbox"],
                "test_images": test_frames, "test_anno": test_anno["bbox"],
                "dataset": dataset.get_name()}
        if "mask" in train_anno:
            data["train_masks"] = train_anno["mask"]
            data["test_masks"] = test_anno["mask"]
        if self.processing is not None:
            data = self.processing(data, self.rng, self.np_rng)
        return data


class DiMPSampler(TrackingSampler):
    """DiMP's sampler: the tracking sampler with its defaults."""
