"""Per-sample processing of the training data pipeline: jitter, crop,
resize, labels and proposals (counterpart of
pytracking_tpu/training/processing.py `BaseProcessing`, `DiMPProcessing`).
Host-side numpy; the result is a dict of fixed-shape float32 arrays. The
random draws come from the generators the sampler passes in.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from pytracking_tpu_torch.training import processing_utils as prutils
from pytracking_tpu_torch.training.transforms import Transform


class BaseProcessing:
    def __init__(self, transform: Optional[Transform] = None,
                 train_transform: Optional[Transform] = None,
                 test_transform: Optional[Transform] = None,
                 joint_transform: Optional[Transform] = None):
        self.transform = {
            "train": train_transform or transform or Transform(),
            "test": test_transform or transform or Transform(),
            "joint": joint_transform,
        }

    def __call__(self, data: dict, rng: random.Random,
                 np_rng: np.random.RandomState) -> dict:
        raise NotImplementedError


class DiMPProcessing(BaseProcessing):
    """DiMP's processing: jitter each target box, crop search_area_factor²
    times its area around it, add IoU-Net proposals and Gaussian score
    labels."""

    def __init__(self, search_area_factor: float, output_sz: int, center_jitter_factor,
                 scale_jitter_factor, crop_type: str = "replicate",
                 max_scale_change=None, mode: str = "sequence",
                 proposal_params: Optional[dict] = None,
                 label_function_params: Optional[dict] = None, **kwargs):
        super().__init__(**kwargs)
        self.search_area_factor = search_area_factor
        self.output_sz = output_sz
        self.center_jitter_factor = center_jitter_factor
        self.scale_jitter_factor = scale_jitter_factor
        self.mode = mode
        self.proposal_params = proposal_params
        self.label_function_params = label_function_params

    def _get_jittered_box(self, box: np.ndarray, mode: str,
                          np_rng: np.random.RandomState) -> np.ndarray:
        jittered_size = box[2:4] * np.exp(np_rng.randn(2) * self.scale_jitter_factor[mode])
        max_offset = np.sqrt(jittered_size.prod()) * self.center_jitter_factor[mode]
        jittered_center = box[0:2] + 0.5 * box[2:4] + max_offset * (np_rng.rand(2) - 0.5)
        return np.concatenate([jittered_center - 0.5 * jittered_size, jittered_size])

    def _generate_label_function(self, target_bb: np.ndarray):
        p = self.label_function_params
        return prutils.gaussian_label_function(
            target_bb, p["sigma_factor"], p["kernel_sz"], p["feature_sz"], self.output_sz,
            end_pad_if_even=p.get("end_pad_if_even", True))

    def __call__(self, data: dict, rng: random.Random,
                 np_rng: np.random.RandomState) -> dict:
        """data {'train_images', 'train_anno', 'test_images', 'test_anno'}
        (lists over frames) -> the crops, the boxes in crop coordinates,
        and with the parameters given 'test_proposals', 'proposal_iou',
        'train_label' and 'test_label'."""
        if self.transform["joint"] is not None:
            data["train_images"], data["train_anno"] = self.transform["joint"](
                image=data["train_images"], bbox=data["train_anno"], rng=rng, np_rng=np_rng)
            data["test_images"], data["test_anno"] = self.transform["joint"](
                image=data["test_images"], bbox=data["test_anno"], joint=False, rng=rng,
                np_rng=np_rng)

        for s in ("train", "test"):
            jittered = [self._get_jittered_box(np.asarray(a, np.float32), s, np_rng)
                        for a in data[s + "_anno"]]
            crops, boxes = prutils.jittered_center_crop(
                data[s + "_images"], jittered, data[s + "_anno"],
                self.search_area_factor, self.output_sz)
            crops, boxes = self.transform[s](image=crops, bbox=boxes, joint=False, rng=rng,
                                             np_rng=np_rng)
            data[s + "_images"] = [np.asarray(c, np.float32) for c in crops]
            data[s + "_anno"] = [np.asarray(b, np.float32) for b in boxes]

        if self.proposal_params:
            p = self.proposal_params
            proposals, gt_iou = zip(*[prutils.gaussian_proposals(
                a, p["boxes_per_frame"], p.get("proposal_sigma", 0.05), rng, np_rng)
                for a in data["test_anno"]])
            data["test_proposals"] = list(proposals)
            data["proposal_iou"] = list(gt_iou)

        if self.label_function_params is not None:
            data["train_label"] = [self._generate_label_function(a[None])[0]
                                   for a in data["train_anno"]]
            data["test_label"] = [self._generate_label_function(a[None])[0]
                                  for a in data["test_anno"]]
        return data
