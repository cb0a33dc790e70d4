"""A VOT polygon as an axis-aligned box (counterpart of
pytracking_tpu/utils/convert_vot_anno.py)."""

from __future__ import annotations

import numpy as np


def convert_vot_anno_to_rect(vot_anno, anno_conversion_type: str = "preserve_area"):
    """[x, y, w, h] of a 4-value box (as it is) or of a polygon's corners
    (x1, y1, x2, y2, ...): 'union' is their bounding box; 'preserve_area'
    (the default) the box of the polygon's centre whose area is the
    product of its first two sides, plus one pixel in each dimension."""
    vot_anno = np.asarray(vot_anno, np.float64).reshape(-1)
    if vot_anno.size == 4:
        return list(vot_anno)

    xs = vot_anno[0::2]
    ys = vot_anno[1::2]

    if anno_conversion_type == "union":
        x1, y1, x2, y2 = xs.min(), ys.min(), xs.max(), ys.max()
        return [x1, y1, x2 - x1, y2 - y1]

    cx, cy = xs.mean(), ys.mean()
    x1, y1, x2, y2 = xs.min(), ys.min(), xs.max(), ys.max()
    A1 = np.linalg.norm(vot_anno[0:2] - vot_anno[2:4]) * \
        np.linalg.norm(vot_anno[2:4] - vot_anno[4:6])
    A2 = (x2 - x1) * (y2 - y1)
    s = np.sqrt(A1 / A2) if A2 > 0 else 1.0
    w = s * (x2 - x1) + 1
    h = s * (y2 - y1) + 1
    return [cx - w / 2, cy - h / 2, w, h]
