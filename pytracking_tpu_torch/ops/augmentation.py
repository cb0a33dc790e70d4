"""First-frame augmentations for tracker initialisation (counterpart of
pytracking_tpu/ops/augmentation.py).

Each transform is a static descriptor, realised as a bilinear warp of an
expanded patch (plus a separable Gaussian blur for 'blur'). The expanded
patch is (C, He, We); each transform gives (C, H, W), H x W the tracker's
sample size; `shift` is (dy, dx) pixels applied to the output crop.
`build_transforms` is numpy only: the random shifts are drawn on the host
once per sequence.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytracking_tpu_torch.ops.patch import bilinear_sample


@dataclass(frozen=True)
class AugTransform:
    """Static descriptor of one init-frame augmentation."""
    kind: str = "identity"            # identity|fliplr|flipud|rotate|scale|blur
    shift: Tuple[float, float] = (0.0, 0.0)   # (dy, dx) output shift in pixels
    angle: float = 0.0                # degrees, for rotate
    scale: float = 1.0                # for scale
    blur_sigma: Tuple[float, float] = (0.0, 0.0)


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    ksz = int(math.ceil(2 * sigma))
    x = np.arange(-ksz, ksz + 1, dtype=np.float32)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def gaussian_blur(im: torch.Tensor, sigma: Tuple[float, float]) -> torch.Tensor:
    """Separable Gaussian blur of im (C, H, W) with sigma (sy, sx): one
    depthwise convolution per axis with a zero-padded 'same' border (the
    kernel is not renormalised where it leaves the image)."""
    out = im
    C = im.shape[0]
    for axis, s in enumerate(sigma):
        if s <= 0:
            continue
        k = torch.from_numpy(_gauss_kernel1d(float(s))).to(im.device)
        n = k.shape[0]
        shape, pad = ((C, 1, n, 1), (n // 2, 0)) if axis == 0 else ((C, 1, 1, n), (0, n // 2))
        out = F.conv2d(out[None], k.reshape(shape[2:]).expand(shape), padding=pad,
                       groups=C)[0]
    return out


def apply_transform(patch: torch.Tensor, t: AugTransform,
                    output_sz: Tuple[int, int]) -> torch.Tensor:
    """One augmentation of the expanded patch (C, He, We), centre-cropped
    with the transform's shift to output_sz: (C, H, W)."""
    He, We = patch.shape[-2], patch.shape[-1]
    H, W = output_sz
    cy, cx = (He - 1) / 2.0, (We - 1) / 2.0
    dev = patch.device
    ys = torch.arange(H, dtype=torch.float32, device=dev) + (He - H) / 2.0 - t.shift[0]
    xs = torch.arange(W, dtype=torch.float32, device=dev) + (We - W) / 2.0 - t.shift[1]
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")

    if t.kind == "fliplr":
        xx = (We - 1) - xx
    elif t.kind == "flipud":
        yy = (He - 1) - yy
    elif t.kind == "rotate":
        a = math.pi * t.angle / 180.0
        dy, dx = yy - cy, xx - cx
        # inverse rotation of the sampling grid
        yy = cy + (-math.sin(a)) * dx + math.cos(a) * dy
        xx = cx + math.cos(a) * dx + math.sin(a) * dy
    elif t.kind == "scale":
        yy = cy + (yy - cy) * t.scale
        xx = cx + (xx - cx) * t.scale

    src = gaussian_blur(patch, t.blur_sigma) if t.kind == "blur" else patch
    return bilinear_sample(src, yy, xx)


def build_transforms(augmentation: dict, sample_sz: Tuple[int, int],
                     random_shift_factor: float = 0.0,
                     rng: Optional[np.random.RandomState] = None,
                     global_shift: Tuple[float, float] = (0.0, 0.0)) -> list:
    """The static augmentation list from a params dict with keys 'fliplr',
    'rotate', 'blur', 'shift', 'relativeshift', 'scale'. Random shifts come
    from `rng`, once per sequence."""
    rng = rng or np.random.RandomState(0)

    def rand_shift():
        if random_shift_factor <= 0:
            return tuple(global_shift)
        s = ((rng.rand(2) - 0.5) * np.asarray(sample_sz) * random_shift_factor
             + np.asarray(global_shift))
        return (float(int(s[0])), float(int(s[1])))

    transforms = [AugTransform("identity", shift=tuple(global_shift))]
    if "shift" in augmentation:
        for sh in augmentation["shift"]:
            transforms.append(AugTransform("identity",
                                           shift=(sh[0] + global_shift[0],
                                                  sh[1] + global_shift[1])))
    if "relativeshift" in augmentation:
        for sh in augmentation["relativeshift"]:
            abs_sh = (float(int(sh[0] * sample_sz[0] / 2)),
                      float(int(sh[1] * sample_sz[1] / 2)))
            transforms.append(AugTransform("identity",
                                           shift=(abs_sh[0] + global_shift[0],
                                                  abs_sh[1] + global_shift[1])))
    if augmentation.get("fliplr", False):
        transforms.append(AugTransform("fliplr", shift=rand_shift()))
    for sigma in augmentation.get("blur", []):
        s = (sigma, sigma) if isinstance(sigma, (int, float)) else tuple(sigma)
        transforms.append(AugTransform("blur", shift=rand_shift(), blur_sigma=s))
    for sc in augmentation.get("scale", []):
        transforms.append(AugTransform("scale", shift=rand_shift(), scale=float(sc)))
    for ang in augmentation.get("rotate", []):
        transforms.append(AugTransform("rotate", shift=rand_shift(), angle=float(ang)))
    return transforms


def apply_all(patch: torch.Tensor, transforms: Sequence[AugTransform],
              output_sz: Tuple[int, int]) -> torch.Tensor:
    """Every transform of the expanded patch (C, He, We): (T, C, H, W)."""
    return torch.stack([apply_transform(patch, t, output_sz) for t in transforms])


def dropout2d(feat: torch.Tensor, keep: torch.Tensor, prob: float) -> torch.Tensor:
    """Channel dropout of the first feature sample: feat (T, C, H, W) and a
    keep mask (num, C, 1, 1) drawn with P(keep) = 1 - prob give
    (num, C, H, W), feat[0] * keep / (1 - prob). The caller draws the mask
    (the JAX function draws it from a key)."""
    return feat[0:1] * keep.to(feat.dtype) / (1.0 - prob)
