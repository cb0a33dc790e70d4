"""Per-sample processing of the training data pipeline: jitter, crop,
resize, labels and proposals (counterpart of
pytracking_tpu/training/processing.py `BaseProcessing`, `DiMPProcessing`,
`ATOMProcessing`, `KLDiMPProcessing`, `ToMPProcessing`, `TaMOsProcessing`,
`LWLProcessing`, `RTSProcessing`, `KYSProcessing`,
`TargetCandidateMatchingProcessing`).
Host-side numpy; the result is a dict of fixed-shape float32 arrays. The
random draws come from the generators the sampler passes in.
"""

from __future__ import annotations

import math
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

    def _generate_label_function(self, target_bb: np.ndarray, feature_sz=None):
        p = self.label_function_params
        return prutils.gaussian_label_function(
            target_bb, p["sigma_factor"], p["kernel_sz"],
            feature_sz if feature_sz is not None else p["feature_sz"], self.output_sz,
            end_pad_if_even=p.get("end_pad_if_even", True))

    def _crops(self, data: dict, rng: random.Random, np_rng: np.random.RandomState) -> dict:
        """The joint transform, then per frame the jittered crop, the box in
        crop coordinates and the split's transform."""
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
        return data

    def __call__(self, data: dict, rng: random.Random,
                 np_rng: np.random.RandomState) -> dict:
        """data {'train_images', 'train_anno', 'test_images', 'test_anno'}
        (lists over frames) -> the crops, the boxes in crop coordinates,
        and with the parameters given 'test_proposals', 'proposal_iou',
        'train_label' and 'test_label'."""
        data = self._crops(data, rng, np_rng)
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


class LWLProcessing(DiMPProcessing):
    """LWL's processing: each frame's image and mask cropped around the
    jittered target box (the mask by `sample_target` alike, then
    thresholded at 0.5), the box carried into crop coordinates, and the
    split's transform applied to the crops, boxes and masks together (a
    flipped crop gets a flipped mask, as upstream's LWLProcessing does; the
    JAX package's flips the image and box only). Gives train_images /
    test_images, train_anno / test_anno, and train_masks / test_masks where
    the data carries masks; with label parameters (RTS) also the Gaussian
    labels train_label / test_label."""

    def __call__(self, data: dict, rng: random.Random,
                 np_rng: np.random.RandomState) -> dict:
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
            if s + "_masks" in data:
                masks = [(prutils.sample_target(np.asarray(m, np.float32), j,
                                                self.search_area_factor,
                                                self.output_sz)[0] > 0.5).astype(np.float32)
                         for m, j in zip(data[s + "_masks"], jittered)]
                crops, boxes, masks = self.transform[s](image=crops, bbox=boxes, mask=masks,
                                                        joint=False, rng=rng, np_rng=np_rng)
                data[s + "_masks"] = [np.asarray(m, np.float32) for m in masks]
            else:
                crops, boxes = self.transform[s](image=crops, bbox=boxes, joint=False,
                                                 rng=rng, np_rng=np_rng)
            data[s + "_images"] = [np.asarray(c, np.float32) for c in crops]
            data[s + "_anno"] = [np.asarray(b, np.float32) for b in boxes]

        if self.label_function_params is not None:
            data["train_label"] = [self._generate_label_function(a[None])[0]
                                   for a in data["train_anno"]]
            data["test_label"] = [self._generate_label_function(a[None])[0]
                                  for a in data["test_anno"]]
        return data


class RTSProcessing(LWLProcessing):
    """RTS's processing: LWL's, given the label parameters of the
    classifier branch."""


class ATOMProcessing(DiMPProcessing):
    """ATOM's processing: DiMP's, given no label parameters (proposals
    only)."""


def _encode_ltrb(box: np.ndarray, output_sz: int, stride: int) -> np.ndarray:
    """The dense LTRB map of a crop-coordinate box on the feature grid of
    `stride` (cell centres at stride * i + stride / 2): (sz, sz, 4)
    distances to the box's left, top, right and bottom edges over
    output_sz, sz = output_sz // stride."""
    sz = output_sz // stride
    loc = np.arange(0, output_sz, stride, np.float32) + stride / 2
    xs = loc[None, :]
    ys = loc[:, None]
    x1, y1, w, h = [float(v) for v in box]
    l = xs - x1
    t = ys - y1
    r = (x1 + w) - xs
    b = (y1 + h) - ys
    l, t, r, b = [np.broadcast_to(v, (sz, sz)) for v in (l, t, r, b)]
    return np.stack([l, t, r, b], axis=-1) / output_sz


class ToMPProcessing(DiMPProcessing):
    """ToMP's processing: DiMP's crops and Gaussian labels, and for every
    train and test frame the dense LTRB map of its box
    ('train_ltrb_target', 'test_ltrb_target', (h, w, 4)) at the label
    parameters' stride (16 by default)."""

    def __call__(self, data: dict, rng: random.Random,
                 np_rng: np.random.RandomState) -> dict:
        data = super().__call__(data, rng, np_rng)
        stride = self.label_function_params.get("stride", 16) \
            if self.label_function_params else 16
        for s in ("train", "test"):
            data[s + "_ltrb_target"] = [
                _encode_ltrb(np.asarray(a, np.float32), self.output_sz, stride)
                for a in data[s + "_anno"]]
        return data


class KLDiMPProcessing(DiMPProcessing):
    """PrDiMP's processing: DiMP's crops, then per test frame proposals
    drawn from a Gaussian mixture around the box (in the centre / log-size
    parametrisation relative to the box's size) with the mixture's density
    at each draw ('proposal_density') and the ground-truth density
    ('gt_density': 1 for proposal 0, the box itself, 0 elsewhere); with the
    label parameters the test frames' label densities ('test_label_density')
    and the train frames' Gaussian labels ('train_label')."""

    def _generate_proposals(self, box: np.ndarray, np_rng: np.random.RandomState):
        """(proposals (P, 4), densities (P,), gt_density (P,)). Each
        proposal draws its mixture component, and each but proposal 0 its
        offset, from np_rng in that order."""
        p = self.proposal_params
        num = p["boxes_per_frame"]
        sigmas = p.get("proposal_sigma", [(0.05, 0.05), (0.5, 0.5)])
        stds = [np.array([s[0], s[0], s[1], s[1]]) for s in sigmas]

        box = np.asarray(box, np.float64)
        proposals = np.zeros((num, 4), np.float32)
        densities = np.zeros((num,), np.float32)
        sz_norm = box[2:]
        center_rel = np.concatenate([(box[:2] + box[2:] / 2) / sz_norm,
                                     np.log(np.maximum(box[2:], 1e-6))])
        for i in range(num):
            std = stds[np_rng.randint(len(sigmas))]
            d = np.zeros(4) if i == 0 else np_rng.randn(4) * std
            rel = center_rel + d
            wh = np.exp(rel[2:])
            proposals[i] = np.concatenate([rel[:2] * sz_norm - wh / 2, wh])
            densities[i] = np.mean([np.prod(np.exp(-0.5 * (d / sg) ** 2)
                                            / (np.sqrt(2 * np.pi) * sg)) for sg in stds])
        gt_density = np.zeros((num,), np.float32)
        gt_density[0] = 1.0
        return proposals, densities, gt_density

    def __call__(self, data: dict, rng: random.Random,
                 np_rng: np.random.RandomState) -> dict:
        data = self._crops(data, rng, np_rng)
        if self.proposal_params:
            out = [self._generate_proposals(a, np_rng) for a in data["test_anno"]]
            data["test_proposals"] = [o[0] for o in out]
            data["proposal_density"] = [o[1] for o in out]
            data["gt_density"] = [o[2] for o in out]

        if self.label_function_params is not None:
            p = self.label_function_params
            data["test_label_density"] = [
                prutils.gaussian_label_function(a[None], p["sigma_factor"], p["kernel_sz"],
                                                p["feature_sz"], self.output_sz,
                                                density=True)[0]
                for a in data["test_anno"]]
            data["train_label"] = [self._generate_label_function(a[None])[0]
                                   for a in data["train_anno"]]
        return data


class TaMOsProcessing(ToMPProcessing):
    """TaMOs's multi-object processing. Annotations are per-frame {obj_id:
    box} dicts (a bare box is {0: box}). Each frame is cropped once, around
    the jittered box of its lowest object id, and every object's box is
    carried into that crop; the split's transform changes the crops only
    (the boxes stay as cropped, as in the JAX package: no joint transform,
    and a flip moves no label). Object id k < num_objects fills slot k of
    the fixed slots; the other slots stay zero. Train frames get slot-first
    Gaussian labels 'train_label' (K, h, w) and LTRB maps
    'train_ltrb_target' (K, h, w, 4) on the label parameters' grid (stride
    16); test frames get slot-last 'test_label' (2h, 2w, K),
    'test_ltrb_target' (2h, 2w, K, 4) and 'test_sample_region' (2h, 2w, K),
    1 where a cell centre lies inside the box, on the stride_high grid (8).
    'train_anno' / 'test_anno' become the crop-coordinate dicts."""

    def __init__(self, *args, num_objects: int = 3, stride_high: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_objects = num_objects
        self.stride_high = stride_high

    def _crop_multi(self, images, annos, mode, np_rng):
        crops, out_annos = [], []
        crop_sz = np.array([self.output_sz, self.output_sz], np.float32)
        for im, a in zip(images, annos):
            anchor = self._get_jittered_box(np.asarray(a[min(a.keys())], np.float32), mode,
                                            np_rng)
            crop, rf = prutils.sample_target(np.asarray(im), anchor, self.search_area_factor,
                                             self.output_sz)
            crops.append(np.asarray(crop, np.float32))
            out_annos.append({k: prutils.transform_image_to_crop(
                np.asarray(b, np.float32), anchor, rf, crop_sz) for k, b in a.items()})
        return crops, out_annos

    def _slots(self, a: dict, feature_sz: int, stride: int, k_last: bool):
        """One frame's {obj_id: box} -> (labels, LTRB maps, sample regions)
        in the K slots."""
        K = self.num_objects
        lbl = np.zeros((K, feature_sz, feature_sz), np.float32)
        ltrb = np.zeros((K, feature_sz, feature_sz, 4), np.float32)
        region = np.zeros((K, feature_sz, feature_sz), np.float32)
        for oid, box in a.items():
            if oid >= K:
                continue
            box = np.asarray(box, np.float32)
            lbl[oid] = self._generate_label_function(box[None], feature_sz=feature_sz)[0]
            ltrb[oid] = _encode_ltrb(box, self.output_sz, stride)
            x, y, w, h = [float(v) for v in box]
            cs = (np.arange(feature_sz) + 0.5) * stride
            region[oid] = ((cs[:, None] >= y) & (cs[:, None] <= y + h)
                           & (cs[None, :] >= x) & (cs[None, :] <= x + w)).astype(np.float32)
        if k_last:
            return lbl.transpose(1, 2, 0), ltrb.transpose(1, 2, 0, 3), region.transpose(1, 2, 0)
        return lbl, ltrb, region

    def __call__(self, data: dict, rng: random.Random,
                 np_rng: np.random.RandomState) -> dict:
        for s in ("train", "test"):
            data[s + "_anno"] = [a if isinstance(a, dict) else {0: np.asarray(a, np.float32)}
                                 for a in data[s + "_anno"]]
        for s in ("train", "test"):
            crops, annos = self._crop_multi(data[s + "_images"], data[s + "_anno"], s, np_rng)
            imgs, _ = self.transform[s](image=crops, bbox=[list(a.values())[0] for a in annos],
                                        joint=False, rng=rng, np_rng=np_rng)
            data[s + "_images"] = [np.asarray(c, np.float32) for c in imgs]
            data[s + "_anno"] = annos

        p = self.label_function_params or {}
        stride = p.get("stride", 16)
        sz_lo = self.output_sz // stride
        sz_hi = self.output_sz // self.stride_high
        train = [self._slots(a, sz_lo, stride, k_last=False) for a in data["train_anno"]]
        data["train_label"] = [t[0] for t in train]
        data["train_ltrb_target"] = [t[1] for t in train]
        test = [self._slots(a, sz_hi, self.stride_high, k_last=True) for a in data["test_anno"]]
        data["test_label"] = [t[0] for t in test]
        data["test_ltrb_target"] = [t[1] for t in test]
        data["test_sample_region"] = [t[2] for t in test]
        return data


class KYSProcessing(BaseProcessing):
    """KYS's processing: a synthetic camera motion per frame (a uniform
    centre offset and a log-normal size, the test frames' offset mirrored
    where it moves the centre more than 2.5 box sizes from the previous
    frame's, retried up to 10 times until enough of the crop lies in the
    image), the crops, min-IoU proposals where `proposal_params` are given,
    and Gaussian labels that are zero on the test frames where the target
    is absent (test_visible x test_valid_anno), so the propagation module
    learns to carry the target through occlusions. The label parameters'
    `end_pad_if_even` (default True, the label one cell larger than the
    feature grid for an even filter) is passed through."""

    def __init__(self, search_area_factor, output_sz, center_jitter_param,
                 scale_jitter_param, proposal_params=None, label_function_params=None,
                 min_crop_inside_ratio=0.0, **kwargs):
        super().__init__(**kwargs)
        self.search_area_factor = search_area_factor
        self.output_sz = output_sz
        self.center_jitter_param = center_jitter_param
        self.scale_jitter_param = scale_jitter_param
        self.proposal_params = proposal_params
        self.label_function_params = label_function_params
        self.min_crop_inside_ratio = min_crop_inside_ratio

    def _check_if_crop_inside_image(self, box, im_shape) -> bool:
        """Whether more than min_crop_inside_ratio of the square crop around
        the box (side ceil(sqrt(w h) * search_area_factor)) lies in the
        image."""
        x, y, w, h = [float(v) for v in box]
        if w <= 0.0 or h <= 0.0:
            return False
        crop_sz = math.ceil(math.sqrt(w * h) * self.search_area_factor)
        x1 = x + 0.5 * w - crop_sz * 0.5
        y1 = y + 0.5 * h - crop_sz * 0.5
        x2, y2 = x1 + crop_sz, y1 + crop_sz
        w_inside = max(min(x2, im_shape[1]) - max(x1, 0), 0)
        h_inside = max(min(y2, im_shape[0]) - max(y1, 0), 0)
        crop_area = (x2 - x1) * (y2 - y1)
        return crop_area > 0 and (w_inside * h_inside / crop_area) > self.min_crop_inside_ratio

    def _generate_synthetic_motion(self, boxes, images, mode: str,
                                   np_rng: np.random.RandomState):
        """The jittered box per frame; [1, 1, 10, 10] where no try fits."""
        out_boxes = []
        for i in range(len(boxes)):
            orig = np.asarray(boxes[i], np.float32)
            jittered = np.array([1.0, 1.0, 10.0, 10.0], np.float32)
            for _ in range(10):
                size = orig[2:4] * np.exp(np_rng.randn(2)
                                          * self.scale_jitter_param[mode + "_factor"])
                max_offset = float(np.sqrt(size.prod())
                                   * self.center_jitter_param[mode + "_factor"])
                offset_factor = np_rng.rand(2) - 0.5
                center = orig[0:2] + 0.5 * orig[2:4] + max_offset * offset_factor
                if self.center_jitter_param.get(mode + "_limit_motion", False) and out_boxes:
                    prev_c = out_boxes[-1][:2] + 0.5 * out_boxes[-1][2:]
                    lim = float(np.sqrt(out_boxes[-1][2:].prod()) * 2.5)
                    for d in range(2):
                        if abs(center[d] - prev_c[d]) > lim:
                            center[d] = orig[d] + 0.5 * orig[d + 2] \
                                - max_offset * offset_factor[d]
                cand = np.concatenate([center - 0.5 * size, size])
                if self._check_if_crop_inside_image(cand, images[i].shape):
                    jittered = cand
                    break
            out_boxes.append(jittered.astype(np.float32))
        return out_boxes

    def _generate_proposals(self, box, rng: random.Random, np_rng: np.random.RandomState):
        """min-IoU perturbations of the box; their IoU mapped to [-1, 1]."""
        p = self.proposal_params
        num = p["boxes_per_frame"]
        proposals = np.zeros((num, 4), np.float32)
        gt_iou = np.zeros(num, np.float32)
        for i in range(num):
            proposals[i], gt_iou[i] = prutils.perturb_box(
                np.asarray(box, np.float32), min_iou=p["min_iou"],
                sigma_factor=p["sigma_factor"], rng=rng, np_rng=np_rng)
        return proposals, gt_iou * 2 - 1

    def __call__(self, data: dict, rng: random.Random,
                 np_rng: np.random.RandomState) -> dict:
        if self.transform["joint"] is not None:
            data["train_images"], data["train_anno"] = self.transform["joint"](
                image=data["train_images"], bbox=data["train_anno"], rng=rng, np_rng=np_rng)
            data["test_images"], data["test_anno"] = self.transform["joint"](
                image=data["test_images"], bbox=data["test_anno"], joint=False, rng=rng,
                np_rng=np_rng)

        for s in ("train", "test"):
            jittered = self._generate_synthetic_motion(
                [np.asarray(a, np.float32) for a in data[s + "_anno"]], data[s + "_images"],
                s, np_rng)
            crops, boxes = prutils.jittered_center_crop(
                data[s + "_images"], jittered, data[s + "_anno"], self.search_area_factor,
                self.output_sz)
            crops, boxes = self.transform[s](image=crops, bbox=boxes, joint=False, rng=rng,
                                             np_rng=np_rng)
            data[s + "_images"] = [np.asarray(c, np.float32) for c in crops]
            data[s + "_anno"] = [np.asarray(b, np.float32) for b in boxes]

        if self.proposal_params:
            proposals, gt_iou = zip(*[self._generate_proposals(a, rng, np_rng)
                                      for a in data["test_anno"]])
            data["test_proposals"] = list(proposals)
            data["proposal_iou"] = list(gt_iou)

        if self.label_function_params is not None:
            p = self.label_function_params

            def label(a):
                return prutils.gaussian_label_function(
                    np.asarray(a, np.float32)[None], p["sigma_factor"], p["kernel_sz"],
                    p["feature_sz"], self.output_sz,
                    end_pad_if_even=p.get("end_pad_if_even", True))[0]

            n_test = len(data["test_anno"])
            visible = np.asarray(data.get("test_visible", np.ones(n_test)), np.float32)
            valid = np.asarray(data.get("test_valid_anno", np.ones(n_test)), np.float32)
            absent = 1.0 - visible * valid
            data["train_label"] = [label(a) for a in data["train_anno"]]
            data["test_label"] = [label(a) * (1.0 - absent[i])
                                  for i, a in enumerate(data["test_anno"])]
        return data


class TargetCandidateMatchingProcessing(BaseProcessing):
    """KeepTrack's candidate matching samples (the JAX package's
    TargetCandidateMatchingProcessing). 'self_sup': one frame cropped twice,
    at its search area and at a jittered copy of it, the candidates matched
    to themselves, a random quarter of them at most dropped from one view
    (re-detection and occlusion), the empty of the K slots filled with fake
    candidates at the farthest of 20 random points inside the search areas,
    and the second view's scores and coordinates noised. 'partial_sup': two
    frames, only the annotated target's candidates matched (with
    probability 0.25 dropped from one frame), the other real candidates
    ignored. Assignment entries: 1 match; in gt_matches the matched slot,
    -1 unmatched (the dustbin), -2 ignored. The draws come from `np_rng`
    in the JAX class's order."""

    def __init__(self, output_sz, num_target_candidates: int = 5, score_map_sz=(23, 23),
                 enable_search_area_aug: bool = True, search_area_jitter_value: int = 100,
                 img_aug_transform: Optional[Transform] = None, **kwargs):
        super().__init__(**kwargs)
        self.output_sz = output_sz
        self.K = num_target_candidates
        self.score_map_sz = score_map_sz
        self.enable_search_area_aug = enable_search_area_aug
        self.sa_jitter = search_area_jitter_value
        self.img_aug_transform = img_aug_transform

    def _candidate_drop_out(self, coords0, coords1, np_rng):
        n = min(coords1.shape[0], self.K)
        n_drop = int(round(0.25 * n * np_rng.rand()))
        idx = np_rng.permutation(n)[:n_drop]
        pad0 = np.zeros((self.K, 2), np.float32)
        pad1 = np.zeros((self.K, 2), np.float32)
        valid0 = np.zeros(self.K, np.float32)
        valid1 = np.zeros(self.K, np.float32)
        pad0[:n] = coords0[:n]
        pad1[:n] = coords1[:n]
        valid0[:n] = 1
        valid1[:n] = 1
        if np_rng.rand() < 0.5:
            pad0[idx] = 0
            valid0[idx] = 0
        else:
            pad1[idx] = 0
            valid1[idx] = 0
        return pad0, pad1, valid0, valid1

    def _pad_with_fake_candidates(self, pads, valids, sa_boxes, im_shape, np_rng):
        """Each empty slot, slot by slot and view by view, gets the one of 20
        uniform points inside its view's search area (clipped to the image)
        farthest from every filled slot of both views."""
        H, W = im_shape[:2]
        lows, highs = [], []
        for sa in sa_boxes:
            x, y, w, h = [int(v) for v in sa]
            lows.append((max(0, y), max(0, x)))
            highs.append((min(H, y + h), min(W, x + w)))
        filled = [v.copy() for v in valids]
        for i in range(self.K):
            for k in range(len(pads)):
                if filled[k][i] == 0:
                    cs = np.stack([
                        np_rng.rand(20) * (highs[k][0] - lows[k][0]) + lows[k][0],
                        np_rng.rand(20) * (highs[k][1] - lows[k][1]) + lows[k][1],
                    ], axis=1)
                    used = np.concatenate([p[f == 1] for p, f in zip(pads, filled)])
                    if used.size:
                        dist = np.sqrt(((used[:, None] - cs[None]) ** 2).sum(-1))
                        best = int(dist.min(axis=0).argmax())
                    else:
                        best = 0
                    pads[k][i] = cs[best]
                    filled[k][i] = 1
        return pads

    def _fake_scores(self, scores, valid, np_rng):
        out = np.zeros(self.K, np.float32)
        n = min(len(scores), self.K)
        out[:n][valid[:n] == 1] = np.asarray(scores, np.float32)[:n][valid[:n] == 1]
        n_fake = int((valid == 0).sum())
        out[valid == 0] = np.minimum(np.abs(np_rng.randn(n_fake)) / 50, 0.025) + 0.05
        return out

    def _augment_scores(self, scores, valid, np_rng):
        out = scores.copy()
        m = valid == 1
        out[m] = np.clip(out[m] + 0.1 * np_rng.randn(int(m.sum())), 0.001, None)
        return out

    def _augment_coords(self, coords, valid, np_rng):
        out = coords.copy()
        m = valid == 1
        out[m] = out[m] + np_rng.randn(int(m.sum()), 2) * 2.0
        return out

    def _img_to_tsm(self, img_coords, sa_box):
        x, y, w, h = [float(v) for v in sa_box]
        r = np.round((img_coords[:, 0] - y) / h * (self.score_map_sz[0] - 1))
        c = np.round((img_coords[:, 1] - x) / w * (self.score_map_sz[1] - 1))
        return np.stack([np.clip(r, 0, self.score_map_sz[0] - 1),
                         np.clip(c, 0, self.score_map_sz[1] - 1)], axis=1).astype(np.int64)

    def _tsm_to_img(self, tsm_coords, sa_box):
        x, y, w, h = [float(v) for v in sa_box]
        return np.stack([
            h * (tsm_coords[:, 0].astype(np.float32) / (self.score_map_sz[0] - 1)) + y,
            w * (tsm_coords[:, 1].astype(np.float32) / (self.score_map_sz[1] - 1)) + x,
        ], axis=1)

    def __call__(self, data: dict, rng: random.Random,
                 np_rng: np.random.RandomState) -> dict:
        """data {'sup_mode', 'img', 'search_area_box' (x, y, w, h),
        'target_candidate_coords' (score-map cells, (row, col)),
        'target_candidate_scores'[, 'target_anno_coord']} (lists over the
        frames) -> the two crops, each view's K candidates in image (y, x)
        and score-map coordinates, scores and validity, and the
        assignment."""
        if data.get("sup_mode", "self_sup") == "self_sup":
            return self._self_sup(data, rng, np_rng)
        return self._partial_sup(data, rng, np_rng)

    def _self_sup(self, data, rng, np_rng):
        img = np.asarray(data["img"][0])
        tsm_coords = np.asarray(data["target_candidate_coords"][0])
        scores = np.asarray(data["target_candidate_scores"][0], np.float32)
        sa_box0 = np.asarray(data["search_area_box"][0], np.float32)
        sa_box1 = sa_box0.copy()
        if self.enable_search_area_aug:
            x, y, w, h = [int(v) for v in sa_box0]
            j = self.sa_jitter
            sa_box1 = np.array([x + np_rng.randint(-w // j, w // j + 1),
                                y + np_rng.randint(-h // j, h // j + 1),
                                w + np_rng.randint(-w // j, w // j + 1),
                                h + np_rng.randint(-h // j, h // j + 1)], np.float32)
        crop0 = prutils.sample_target_from_crop_region(img, sa_box0, self.output_sz)
        crop1 = prutils.sample_target_from_crop_region(img, sa_box1, self.output_sz)
        if self.transform["train"] is not None:
            crop0 = np.asarray(self.transform["train"](image=[crop0], rng=rng,
                                                       np_rng=np_rng)[0], np.float32)
        if self.img_aug_transform is not None:
            crop1 = np.asarray(self.img_aug_transform(image=[crop1], rng=rng,
                                                      np_rng=np_rng)[0], np.float32)
        img_coords = self._tsm_to_img(tsm_coords, sa_box0)
        p0, p1, v0, v1 = self._candidate_drop_out(img_coords, img_coords.copy(), np_rng)
        p0, p1 = self._pad_with_fake_candidates([p0, p1], [v0, v1], [sa_box0, sa_box1],
                                                img.shape, np_rng)
        s0 = self._fake_scores(scores, v0, np_rng)
        s1 = self._augment_scores(self._fake_scores(scores, v1, np_rng), v1, np_rng)
        p1 = self._augment_coords(p1, v1, np_rng)

        gt_assign = np.zeros((self.K, self.K), np.float32)
        gt_assign[np.arange(self.K), np.arange(self.K)] = v0 * v1
        gt_m0 = np.arange(self.K, dtype=np.float32)
        gt_m1 = np.arange(self.K, dtype=np.float32)
        gt_m0[(v0 == 0) | (v1 == 0)] = -1
        gt_m1[(v0 == 0) | (v1 == 0)] = -1
        return {
            "img_cropped0": np.asarray(crop0, np.float32),
            "img_cropped1": np.asarray(crop1, np.float32),
            "candidate_img_coords0": p0, "candidate_img_coords1": p1,
            "candidate_tsm_coords0": self._img_to_tsm(p0, sa_box0),
            # real candidates keep frame 0's search area; fakes were drawn in the jittered one
            "candidate_tsm_coords1": np.where((v1 == 1)[:, None], self._img_to_tsm(p1, sa_box0),
                                              self._img_to_tsm(p1, sa_box1)),
            "candidate_scores0": s0, "candidate_scores1": s1,
            "candidate_valid0": v0, "candidate_valid1": v1,
            "img_shape0": np.asarray(img.shape[:2], np.int64),
            "img_shape1": np.asarray(img.shape[:2], np.int64),
            "gt_assignment": gt_assign, "gt_matches0": gt_m0, "gt_matches1": gt_m1,
        }

    def _partial_sup(self, data, rng, np_rng):
        imgs = [np.asarray(i) for i in data["img"]]
        sa = [np.asarray(b, np.float32) for b in data["search_area_box"]]
        tsm = [np.asarray(c) for c in data["target_candidate_coords"]]
        scores = [np.asarray(s, np.float32) for s in data["target_candidate_scores"]]
        anno = [np.asarray(a) for a in data["target_anno_coord"]]

        crops = [prutils.sample_target_from_crop_region(im, b, self.output_sz)
                 for im, b in zip(imgs, sa)]
        if self.transform["train"] is not None:
            crops = [np.asarray(self.transform["train"](image=[c], rng=rng, np_rng=np_rng)[0],
                                np.float32) for c in crops]

        # the target's candidate: the nearest to the annotation (L1, in cells)
        g0, g1 = [int(np.abs(c - a[None]).sum(axis=1).argmin()) for c, a in zip(tsm, anno)]
        img_coords = [self._tsm_to_img(t, b) for t, b in zip(tsm, sa)]

        drop = np_rng.rand() < 0.25
        frame_id = np_rng.randint(2)
        pads, valids = [], []
        for k, gi in enumerate((g0, g1)):
            pad = np.zeros((self.K, 2), np.float32)
            val = np.zeros(self.K, np.float32)
            n = min(len(img_coords[k]), self.K)
            pad[:n] = img_coords[k][:n]
            val[:n] = 1
            if drop and frame_id == k and gi < self.K:
                pad[gi] = 0
                val[gi] = 0
            pads.append(pad)
            valids.append(val)
        pads = self._pad_with_fake_candidates(pads, valids, sa, imgs[0].shape, np_rng)
        s_pad = [self._fake_scores(s, v, np_rng) for s, v in zip(scores, valids)]

        gt_assign = np.zeros((self.K, self.K), np.float32)
        gt_m0 = np.full(self.K, -2, np.float32)
        gt_m1 = np.full(self.K, -2, np.float32)
        if g0 < self.K and g1 < self.K:
            gt_assign[g0, g1] = valids[0][g0] * valids[1][g1]
            if drop and frame_id == 0:
                gt_m1[g1] = -1
            elif drop and frame_id == 1:
                gt_m0[g0] = -1
            else:
                gt_m0[g0] = g1
                gt_m1[g1] = g0
        return {
            "img_cropped0": np.asarray(crops[0], np.float32),
            "img_cropped1": np.asarray(crops[1], np.float32),
            "candidate_img_coords0": pads[0], "candidate_img_coords1": pads[1],
            "candidate_tsm_coords0": self._img_to_tsm(pads[0], sa[0]),
            "candidate_tsm_coords1": self._img_to_tsm(pads[1], sa[1]),
            "candidate_scores0": s_pad[0], "candidate_scores1": s_pad[1],
            "candidate_valid0": valids[0], "candidate_valid1": valids[1],
            "img_shape0": np.asarray(imgs[0].shape[:2], np.int64),
            "img_shape1": np.asarray(imgs[1].shape[:2], np.int64),
            "gt_assignment": gt_assign, "gt_matches0": gt_m0, "gt_matches1": gt_m1,
        }
