"""Training sample sampler: dataset -> sequence -> train and test frames
(counterpart of pytracking_tpu/training/sampler.py `TrackingSampler`,
`DiMPSampler`, `ATOMSampler`, `LWLSampler`,
`TaMOsDatasetSampler`, `KYSSampler`): causal or interval frame sampling within
max_gap under the visibility constraints.

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
    # whether a dataset's 'mask' annotation goes into train_masks /
    # test_masks: only for the segmentation recipes (LWLSampler), as
    # upstream; a box recipe's processing would pass the frame-sized masks
    # on uncropped, and a batch mixing them with a video dataset's samples
    # could not be collated
    carries_masks = False

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
        if self.carries_masks and "mask" in train_anno:
            data["train_masks"] = train_anno["mask"]
            data["test_masks"] = test_anno["mask"]
        if self.processing is not None:
            data = self.processing(data, self.rng, self.np_rng)
        return data


class DiMPSampler(TrackingSampler):
    """DiMP's sampler: the tracking sampler with its defaults."""


class ATOMSampler(TrackingSampler):
    """ATOM's sampler: one train and one test frame, sampled within max_gap
    of each other around a visible base frame ('interval')."""

    def __init__(self, datasets, p_datasets=None, samples_per_epoch=1000, max_gap=30,
                 processing=None, frame_sample_mode="interval", seed: Optional[int] = None):
        super().__init__(datasets, p_datasets, samples_per_epoch, max_gap,
                         num_test_frames=1, num_train_frames=1, processing=processing,
                         frame_sample_mode=frame_sample_mode, seed=seed)


class LWLSampler(TrackingSampler):
    """LWL's and RTS's sampler: the tracking sampler's frames, with a
    dataset's 'mask' annotation carried into train_masks / test_masks."""

    carries_masks = True


class TaMOsDatasetSampler(TrackingSampler):
    """TaMOs's multi-object sampler: a sequence with enough frames where
    some object is visible (visibility may be per frame or per (frame,
    object)), one visible base frame as the train frame and the test frames
    after it within max_gap (the base frame again where none is visible);
    an image dataset gives frame 0 to both. Annotations become per-frame
    {obj_id: box} dicts, {0: box} for a single-object dataset, for
    TaMOsProcessing; 'is_mot' says whether the dataset is a multi-object
    one."""

    def __getitem__(self, index: int) -> dict:
        rng = self.rng
        dataset = rng.choices(self.datasets, self.p_datasets)[0]
        is_video = dataset.is_video_sequence()
        is_mot = getattr(dataset, "is_mot_dataset", lambda: False)()

        for _ in range(100):
            seq_id = rng.randint(0, dataset.get_num_sequences() - 1)
            info = dataset.get_sequence_info(seq_id)
            visible = info.get("visible")
            if visible is None:
                visible = np.ones(len(info["bbox"]), bool)
            visible = np.asarray(visible)
            if visible.ndim == 2:
                visible = visible.any(axis=1)
            if not is_video or (visible.sum() > 2 * (self.num_train_frames +
                                                     self.num_test_frames)
                                and len(visible) >= 20):
                break

        if is_video:
            base = self._sample_visible_ids(visible, 1, self.num_train_frames - 1,
                                            len(visible) - self.num_test_frames)
            base = [0] if base is None else base
            train_ids = base
            test_ids = self._sample_visible_ids(visible, self.num_test_frames, base[0] + 1,
                                                base[0] + self.max_gap) \
                or base * self.num_test_frames
        else:
            train_ids = [0] * self.num_train_frames
            test_ids = [0] * self.num_test_frames

        train_frames, train_anno, _ = dataset.get_frames(seq_id, train_ids, info)
        test_frames, test_anno, _ = dataset.get_frames(seq_id, test_ids, info)

        def to_dicts(anno):
            return [{int(k): np.asarray(v, np.float32) for k, v in a.items()}
                    if isinstance(a, dict) else {0: np.asarray(a, np.float32)}
                    for a in anno["bbox"]]

        data = {"train_images": train_frames, "train_anno": to_dicts(train_anno),
                "test_images": test_frames, "test_anno": to_dicts(test_anno),
                "dataset": dataset.get_name(), "is_mot": is_mot}
        if self.processing is not None:
            data = self.processing(data, self.rng, self.np_rng)
        return data


class KYSSampler:
    """KYS's sequence sampler ('Sequence' mode): num_train_frames train frames
    within max_train_gap before a base frame, and num_test_frames
    consecutive test frames from it, the frames past the sequence's end
    padded with frame 0 and marked in test_valid_image. For a dataset with
    occlusion information (`has_occlusion_info`) and
    sample_occluded_sequences, the sub-sequence spans the first occlusion:
    the base 5-20 frames before it, the test frames spread evenly to 5-20
    frames past its end. Each sample carries 'jitter_seed', a per-sample
    seed of the score jitter, and the test frames' visibility and validity;
    its generators, `rng` and `np_rng`, are its own, as TrackingSampler's."""

    def __init__(self, datasets: List, p_datasets: Optional[List[float]] = None,
                 samples_per_epoch: int = 1000, sequence_sample_info: Optional[dict] = None,
                 processing=None, sample_occluded_sequences: bool = False,
                 seed: Optional[int] = None):
        self.datasets = datasets
        p = p_datasets or [1 for _ in datasets]
        s = sum(p)
        self.p_datasets = [x / s for x in p]
        self.samples_per_epoch = samples_per_epoch
        self.info = sequence_sample_info or {}
        self.processing = processing
        self.sample_occluded_sequences = sample_occluded_sequences
        self.rng = random.Random()
        self.np_rng = np.random.RandomState()
        self.seed(seed)

    def seed(self, seed: Optional[int]) -> None:
        """Reseed both generators (from the OS's entropy when None)."""
        self.rng.seed(seed)
        self.np_rng.seed(seed)

    def __len__(self):
        return self.samples_per_epoch

    def _sample_ids(self, valid, num_ids=1, min_id=None, max_id=None):
        min_id = max(0, min_id if min_id is not None else 0)
        max_id = len(valid) if max_id is None or max_id > len(valid) else max_id
        ids = [i for i in range(min_id, int(max_id)) if valid[i]]
        if not ids:
            return None
        return self.rng.choices(ids, k=num_ids)

    @staticmethod
    def _occlusion_end(first_occ, not_fully_visible):
        for i in range(first_occ, len(not_fully_visible)):
            if not not_fully_visible[i]:
                return i
        return len(not_fully_visible)

    def __getitem__(self, index: int) -> dict:
        """A sub-sequence, processed. `index` is not used: every call draws
        anew."""
        rng = self.rng
        dataset = rng.choices(self.datasets, self.p_datasets)[0]
        is_video = dataset.is_video_sequence()
        num_train = self.info.get("num_train_frames", 3)
        num_test = self.info.get("num_test_frames", 10)
        max_train_gap = self.info.get("max_train_gap", 30)
        min_frac = self.info.get("min_fraction_valid_frames", 0.0)

        while True:
            seq_id = rng.randint(0, dataset.get_num_sequences() - 1)
            seq_info = dataset.get_sequence_info(seq_id)
            visible = np.asarray(seq_info["visible"])
            if not is_video or (visible.sum() > 0 and len(visible) >= 20):
                break

        visible_ratio = np.asarray(seq_info.get("visible_ratio", visible), np.float32)
        test_valid_image = np.zeros(num_test, np.int8)
        train_ids = test_ids = None
        gap_increase = 0
        while test_ids is None:
            occ_sampling = False
            if self.sample_occluded_sequences and \
                    getattr(dataset, "has_occlusion_info", lambda: False)():
                not_fully_visible = visible_ratio < 0.9
                occ_sampling = bool(not_fully_visible.sum() > 0)

            if occ_sampling:
                first_occ = int(np.nonzero(not_fully_visible)[0][0])
                occ_end = self._occlusion_end(first_occ, not_fully_visible)
                base = self._sample_ids(visible, 1, max(0, first_occ - 20), first_occ - 5)
                base = 0 if base is None else base[0]
            else:
                base = self._sample_ids(visible, 1, 2 * num_train,
                                        len(visible) - int(num_test * min_frac))
                base = 0 if base is None else base[0]
            prev = self._sample_ids(visible, num_train,
                                    base - max_train_gap - gap_increase - 1, base - 1)
            if prev is None:
                if base - max_train_gap - gap_increase - 1 < 0:
                    prev = [base] * num_train
                else:
                    gap_increase += 5
                    continue
            train_ids = prev
            if occ_sampling:
                end = min(occ_end + rng.randint(5, 20), len(visible) - 1)
                if (end - base) < num_test:
                    rem = num_test - (end - base)
                    end = rng.randint(end, min(len(visible) - 1, end + rem))
                    base = max(0, end - num_test + 1)
                    end = min(end, len(visible) - 1)
                step = float(end - base) / float(num_test)
                test_ids = [base + int(x * step) for x in range(num_test)]
            else:
                test_ids = list(range(base, min(len(visible), base + num_test)))
            test_valid_image[:len(test_ids)] = 1
            test_ids += [0] * (num_test - len(test_ids))

        train_frames, train_anno, _ = dataset.get_frames(seq_id, train_ids, seq_info)
        test_frames, test_anno, _ = dataset.get_frames(seq_id, test_ids, seq_info)
        data = {
            "train_images": train_frames, "train_anno": train_anno["bbox"],
            "test_images": test_frames, "test_anno": test_anno["bbox"],
            "test_valid_anno": np.asarray(test_anno.get("valid", np.ones(num_test)),
                                          np.float32),
            "test_visible": np.asarray(test_anno.get("visible", np.ones(num_test)),
                                       np.float32),
            "test_valid_image": test_valid_image,
            "test_visible_ratio": np.asarray(test_anno.get("visible_ratio",
                                                           np.ones(num_test)), np.float32),
            "jitter_seed": np.int32(rng.getrandbits(31)),
            "dataset": dataset.get_name(),
        }
        if self.processing is not None:
            data = self.processing(data, self.rng, self.np_rng)
        return data
