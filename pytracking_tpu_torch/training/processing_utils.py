"""Host-side geometry and label primitives of the training data pipeline
(counterpart of pytracking_tpu/training/processing_utils.py). Pure numpy.

Every random draw comes from the generators the caller passes: a
`random.Random` (`rng`) and a `np.random.RandomState` (`np_rng`), owned by
the sampler. Drawn in the same order, they give the numbers the JAX
module's draws from the global `random` / `np.random` give after
`random.seed(s)` / `np.random.seed(s)`.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Tuple

import numpy as np


def _resize(im: np.ndarray, out_sz: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to out_sz (h, w): cv2 where it is installed, else PIL."""
    try:
        import cv2
        return cv2.resize(im, (out_sz[1], out_sz[0]), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        from PIL import Image
        return np.asarray(Image.fromarray(im).resize((out_sz[1], out_sz[0]),
                                                     Image.BILINEAR))


def sample_target(im: np.ndarray, target_bb, search_area_factor: float,
                  output_sz: Optional[int] = None):
    """Crop a square search_area_factor² times the target's area, centred
    on the target and padded with zeros outside the image, resized to
    output_sz. Returns (crop, resize_factor)."""
    x, y, w, h = [float(v) for v in target_bb]
    crop_sz = math.ceil(math.sqrt(w * h) * search_area_factor)
    if crop_sz < 1:
        raise Exception("Too small bounding box.")

    x1 = round(x + 0.5 * w - crop_sz * 0.5)
    x2 = x1 + crop_sz
    y1 = round(y + 0.5 * h - crop_sz * 0.5)
    y2 = y1 + crop_sz

    x1_pad = max(0, -x1)
    x2_pad = max(x2 - im.shape[1] + 1, 0)
    y1_pad = max(0, -y1)
    y2_pad = max(y2 - im.shape[0] + 1, 0)

    im_crop = im[y1 + y1_pad:y2 - y2_pad, x1 + x1_pad:x2 - x2_pad]
    im_crop_padded = np.pad(im_crop,
                            ((y1_pad, y2_pad), (x1_pad, x2_pad)) +
                            ((0, 0),) * (im.ndim - 2), mode="constant")
    if output_sz is None:
        return im_crop_padded, 1.0
    resize_factor = output_sz / crop_sz
    return _resize(im_crop_padded, (output_sz, output_sz)), resize_factor


def sample_target_from_crop_region(im: np.ndarray, crop_box,
                                   output_sz: int) -> np.ndarray:
    """Crop an explicit (x, y, w, h) region (zeros outside the image) and
    resize it to output_sz."""
    x, y, w, h = [int(round(float(v))) for v in crop_box]
    x1, y1, x2, y2 = x, y, x + w, y + h
    x1_pad, y1_pad = max(0, -x1), max(0, -y1)
    x2_pad = max(x2 - im.shape[1], 0)
    y2_pad = max(y2 - im.shape[0], 0)
    crop = im[y1 + y1_pad:y2 - y2_pad, x1 + x1_pad:x2 - x2_pad]
    crop = np.pad(crop, ((y1_pad, y2_pad), (x1_pad, x2_pad)) +
                  ((0, 0),) * (im.ndim - 2), mode="constant")
    return _resize(crop, (output_sz, output_sz))


def transform_image_to_crop(box_in: np.ndarray, box_extract: np.ndarray,
                            resize_factor: float, crop_sz: np.ndarray) -> np.ndarray:
    """A box in image coordinates -> the coordinates of the crop that
    `sample_target` cut around box_extract."""
    box_extract_center = box_extract[0:2] + 0.5 * box_extract[2:4]
    box_in_center = box_in[0:2] + 0.5 * box_in[2:4]
    box_out_center = (crop_sz - 1) / 2 + (box_in_center - box_extract_center) * resize_factor
    box_out_wh = box_in[2:4] * resize_factor
    return np.concatenate([box_out_center - 0.5 * box_out_wh, box_out_wh])


def jittered_center_crop(frames: List[np.ndarray], box_extract: List[np.ndarray],
                         box_gt: List[np.ndarray], search_area_factor: float,
                         output_sz: int):
    """Crop around the (jittered) boxes box_extract and carry the ground
    truth boxes into crop coordinates. Returns (crops, boxes)."""
    crops_resize_factors = [sample_target(f, a, search_area_factor, output_sz)
                            for f, a in zip(frames, box_extract)]
    frames_crop, resize_factors = zip(*crops_resize_factors)
    crop_sz = np.array([output_sz, output_sz], np.float32)
    box_crop = [transform_image_to_crop(np.asarray(bg, np.float32),
                                        np.asarray(be, np.float32), rf, crop_sz)
                for bg, be, rf in zip(box_gt, box_extract, resize_factors)]
    return list(frames_crop), box_crop


def iou(reference: np.ndarray, proposals: np.ndarray) -> np.ndarray:
    """IoU of (x, y, w, h) boxes, broadcast over the leading axes."""
    tl = np.maximum(reference[..., :2], proposals[..., :2])
    br = np.minimum(reference[..., :2] + reference[..., 2:],
                    proposals[..., :2] + proposals[..., 2:])
    sz = np.clip(br - tl, 0, None)
    intersection = sz.prod(-1)
    union = reference[..., 2:].prod(-1) + proposals[..., 2:].prod(-1) - intersection
    return intersection / np.maximum(union, 1e-12)


def rand_uniform(a, b, np_rng: np.random.RandomState, shape=1):
    """Uniform draw(s) in [a, b) from np_rng: a float for shape 1."""
    return (b - a) * np_rng.rand(shape) + a if shape != 1 \
        else float((b - a) * np_rng.rand() + a)


def perturb_box(box: np.ndarray, min_iou: float, sigma_factor, rng: random.Random,
                np_rng: np.random.RandomState) -> Tuple[np.ndarray, float]:
    """Gaussian perturbation of box's centre and size until the IoU with
    the box exceeds min_iou (the spread shrinks by 0.9 per try, 100 tries).
    Returns (box, IoU)."""
    if isinstance(sigma_factor, (list, tuple, np.ndarray)):
        c_sigma_factor = np.asarray(rng.choice(list(sigma_factor)))
    else:
        c_sigma_factor = np.asarray(sigma_factor)
    if c_sigma_factor.size == 1:
        c_sigma_factor = c_sigma_factor * np.ones(4)
    perturb_factor = np.sqrt(box[2] * box[3]) * c_sigma_factor

    for _ in range(100):
        c_x = box[0] + 0.5 * box[2]
        c_y = box[1] + 0.5 * box[3]
        c_x_per = np_rng.normal(c_x, perturb_factor[0])
        c_y_per = np_rng.normal(c_y, perturb_factor[1])
        w_per = np_rng.normal(box[2], perturb_factor[2])
        h_per = np_rng.normal(box[3], perturb_factor[3])
        if w_per <= 1:
            w_per = box[2] * rand_uniform(0.15, 0.5, np_rng)
        if h_per <= 1:
            h_per = box[3] * rand_uniform(0.15, 0.5, np_rng)
        box_per = np.array([c_x_per - 0.5 * w_per, c_y_per - 0.5 * h_per,
                            w_per, h_per])
        box_iou = iou(box, box_per)
        if box_iou > min_iou:
            return box_per, float(box_iou)
        perturb_factor = perturb_factor * 0.9
    return box_per, float(box_iou)


def gauss_1d(sz: int, sigma: float, center: np.ndarray, end_pad: int = 0,
             density: bool = False) -> np.ndarray:
    """Gaussians at centers (B,) on a grid of sz (+ end_pad) -> (B, sz + end_pad)."""
    k = np.arange(-(sz - 1) / 2, (sz + 1) / 2 + end_pad)[None]
    gauss = np.exp(-1.0 / (2 * sigma ** 2) * (k - center[:, None]) ** 2)
    if density:
        gauss /= math.sqrt(2 * math.pi) * sigma
    return gauss


def gauss_2d(sz, sigma, center: np.ndarray, end_pad=(0, 0), density=False):
    """Separable 2-D Gaussians at centers (B, 2) -> (B, h, w)."""
    if isinstance(sigma, (float, int)):
        sigma = (sigma, sigma)
    sz = (sz, sz) if isinstance(sz, int) else sz
    return gauss_1d(sz[0], sigma[0], center[:, 0], end_pad[0], density)[:, :, None] * \
        gauss_1d(sz[1], sigma[1], center[:, 1], end_pad[1], density)[:, None, :]


def gaussian_label_function(target_bb: np.ndarray, sigma_factor, kernel_sz,
                            feat_sz, image_sz, end_pad_if_even: bool = True,
                            density: bool = False, uni_bias: float = 0.0):
    """Gaussian score-map labels for boxes (B, 4) (x, y, w, h) in crop
    coordinates -> (B, feat_h (+1), feat_w (+1)) float32, one cell more per
    even kernel dimension with end_pad_if_even."""
    target_bb = np.atleast_2d(np.asarray(target_bb, np.float64))
    kernel_sz = (kernel_sz, kernel_sz) if isinstance(kernel_sz, int) else kernel_sz
    feat_sz = (feat_sz, feat_sz) if isinstance(feat_sz, int) else feat_sz
    image_sz = (image_sz, image_sz) if isinstance(image_sz, int) else image_sz
    image_sz = np.asarray(image_sz, np.float64)
    feat_sz_arr = np.asarray(feat_sz, np.float64)

    target_center = target_bb[:, 0:2] + 0.5 * target_bb[:, 2:4]
    target_center_norm = (target_center - image_sz / 2) / image_sz

    center = feat_sz_arr * target_center_norm[:, ::-1] + \
        0.5 * np.array([(kernel_sz[0] + 1) % 2, (kernel_sz[1] + 1) % 2])
    sigma = sigma_factor * np.mean(feat_sz_arr)

    if end_pad_if_even:
        end_pad = (int((kernel_sz[0] + 1) % 2), int((kernel_sz[1] + 1) % 2))
    else:
        end_pad = (0, 0)
    gauss_label = gauss_2d(feat_sz, sigma, center, end_pad, density=density)
    if density:
        sz = (feat_sz_arr[0] + end_pad[0]) * (feat_sz_arr[1] + end_pad[1])
        label = (1.0 - uni_bias) * gauss_label + uni_bias / sz
    else:
        label = gauss_label + uni_bias
    return label.astype(np.float32)


def gaussian_proposals(box: np.ndarray, num_proposals: int, proposal_sigma,
                       rng: random.Random, np_rng: np.random.RandomState):
    """IoU-Net training proposals: num_proposals perturbations of box with
    IoU above 0.1, and their IoUs mapped to [-1, 1]."""
    proposals = np.zeros((num_proposals, 4), np.float32)
    gt_iou = np.zeros(num_proposals, np.float32)
    for i in range(num_proposals):
        proposals[i], gt_iou[i] = perturb_box(np.asarray(box, np.float64), 0.1,
                                              proposal_sigma, rng, np_rng)
    return proposals, gt_iou * 2 - 1
