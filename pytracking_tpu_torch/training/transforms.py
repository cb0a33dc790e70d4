"""Joint image / box / mask augmentations of the training data pipeline
(counterpart of pytracking_tpu/training/transforms.py). Host-side numpy.

A `Transform` chain rolls each augmentation's random parameters once per
call (or once per element with joint=False) from the generators passed to
it, `rng` (`random.Random`) and `np_rng` (`np.random.RandomState`), and
applies them to every image, box and mask given. Images are HWC RGB;
boxes (x, y, w, h); masks HW.
"""

from __future__ import annotations

import random

import numpy as np


class TransformBase:
    """One augmentation: override roll() and the transform_* methods."""

    def roll(self, rng: random.Random, np_rng: np.random.RandomState):
        return None

    def transform_image(self, image, rolled):
        return image

    def transform_bbox(self, bbox, rolled, image_shape):
        return bbox

    def transform_mask(self, mask, rolled):
        return mask


class Transform:
    """A chain of TransformBase. Call with image=, bbox=, mask= (each one
    item or a list), the generators rng= and np_rng=, and optionally
    joint=False to roll per element."""

    def __init__(self, *transforms: TransformBase):
        self.transforms = list(transforms)

    def __call__(self, image=None, bbox=None, mask=None, joint: bool = True, *,
                 rng: random.Random, np_rng: np.random.RandomState):
        single = not isinstance(image, (list, tuple)) if image is not None else \
            not isinstance(bbox, (list, tuple))
        images = [image] if single and image is not None else (image or [])
        bboxes = [bbox] if single and bbox is not None else (bbox or [])
        masks = [mask] if single and mask is not None else (mask or [])

        n = max(len(images), len(bboxes), len(masks))
        rolls_per_t = []
        for t in self.transforms:
            if joint:
                rolls_per_t.append([t.roll(rng, np_rng)] * n)
            else:
                rolls_per_t.append([t.roll(rng, np_rng) for _ in range(n)])

        out_images, out_bboxes, out_masks = list(images), list(bboxes), list(masks)
        for t, rolls in zip(self.transforms, rolls_per_t):
            for i in range(n):
                shape = out_images[i].shape if i < len(out_images) else None
                if i < len(out_images):
                    out_images[i] = t.transform_image(out_images[i], rolls[i])
                if i < len(out_bboxes):
                    out_bboxes[i] = t.transform_bbox(out_bboxes[i], rolls[i], shape)
                if i < len(out_masks):
                    out_masks[i] = t.transform_mask(out_masks[i], rolls[i])

        result = []
        if image is not None:
            result.append(out_images[0] if single else out_images)
        if bbox is not None:
            result.append(out_bboxes[0] if single else out_bboxes)
        if mask is not None:
            result.append(out_masks[0] if single else out_masks)
        return result[0] if len(result) == 1 else tuple(result)


class ToGrayscale(TransformBase):
    """The luma (0.299, 0.587, 0.114) in all three channels, with `probability`."""

    def __init__(self, probability: float = 0.5):
        self.probability = probability

    def roll(self, rng, np_rng):
        return rng.random() < self.probability

    def transform_image(self, image, do_gray):
        if do_gray:
            w = np.array([0.299, 0.587, 0.114], image.dtype if
                         np.issubdtype(image.dtype, np.floating) else np.float32)
            gray = (image @ w)
            return np.stack([gray] * 3, axis=-1).astype(image.dtype)
        return image


class RandomHorizontalFlip(TransformBase):
    """Mirror image, box and mask left-right, with `probability`."""

    def __init__(self, probability: float = 0.5):
        self.probability = probability

    def roll(self, rng, np_rng):
        return rng.random() < self.probability

    def transform_image(self, image, do_flip):
        return np.ascontiguousarray(image[:, ::-1]) if do_flip else image

    def transform_bbox(self, bbox, do_flip, image_shape):
        if do_flip:
            bbox = np.asarray(bbox, np.float32).copy()
            bbox[0] = image_shape[1] - bbox[0] - bbox[2]
        return bbox

    def transform_mask(self, mask, do_flip):
        return np.ascontiguousarray(mask[:, ::-1]) if do_flip else mask


class BrightnessJitter(TransformBase):
    """Scale the image by a factor drawn from [1 - j, 1 + j] (at least 0),
    clipped to [0, 255], as float32."""

    def __init__(self, brightness_jitter: float = 0.2):
        self.brightness_jitter = brightness_jitter

    def roll(self, rng, np_rng):
        return np_rng.uniform(max(0, 1 - self.brightness_jitter), 1 + self.brightness_jitter)

    def transform_image(self, image, factor):
        return np.clip(image.astype(np.float32) * factor, 0, 255)


class Normalize(TransformBase):
    """No-op kept for the recipes: the net normalises its input on the
    device (`models/backbones/resnet.normalize_image`)."""

    def __init__(self, mean=None, std=None):
        pass


class Blur(TransformBase):
    """Gaussian blur with `probability`, sigma drawn from sigma_range (cv2;
    without cv2 the image is left as it is)."""

    def __init__(self, probability: float = 0.2, sigma_range=(0.2, 2.0)):
        self.probability = probability
        self.sigma_range = sigma_range

    def roll(self, rng, np_rng):
        if rng.random() < self.probability:
            return rng.uniform(*self.sigma_range)
        return None

    def transform_image(self, image, sigma):
        if sigma is None:
            return image
        try:
            import cv2
            k = int(2 * round(2 * sigma) + 1)
            return cv2.GaussianBlur(image.astype(np.float32), (k, k), sigma)
        except ImportError:
            return image
