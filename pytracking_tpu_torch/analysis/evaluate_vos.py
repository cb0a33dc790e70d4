"""DAVIS-style VOS evaluation: region similarity J and boundary accuracy F
(counterpart of pytracking_tpu/analysis/evaluate_vos.py, with the same
numbers). Reads the indexed PNGs the harness saved, computes J and F per
object and frame against the ground-truth masks, and prints the mean /
recall / decay table.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np


def binary_jaccard(pred: np.ndarray, gt: np.ndarray) -> float:
    """Region similarity J = |A∩B| / |A∪B| (reference vos_utils.py)."""
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 1.0
    return float(inter) / float(union)


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Boundary map of a binary mask (reference vos_utils.py seg2bmap): a pixel is
    boundary if it differs from a 4-neighbour or touches the image border while set."""
    seg = seg.astype(bool)
    bmap = np.zeros_like(seg)
    bmap[:-1] |= seg[:-1] ^ seg[1:]
    bmap[:, :-1] |= seg[:, :-1] ^ seg[:, 1:]
    bmap[-1] |= seg[-1]
    bmap[:, -1] |= seg[:, -1]
    return bmap & seg | (np.zeros_like(seg) | bmap) & ~seg | bmap


def _dilate(m: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation with a square structuring element (no scipy dependency)."""
    out = m.copy()
    for _ in range(radius):
        p = np.pad(out, 1)
        out = (p[1:-1, 1:-1] | p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2]
               | p[1:-1, 2:])
    return out


def boundary_f_measure(pred: np.ndarray, gt: np.ndarray,
                       bound_th: float = 0.008) -> float:
    """Boundary F-score (reference vos_utils.py davis_f_measure): match predicted and
    GT boundaries within a distance tolerance proportional to the image diagonal."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    bound_pix = max(1, int(np.ceil(bound_th * np.linalg.norm(pred.shape))))
    fg_boundary = _seg2bmap(pred)
    gt_boundary = _seg2bmap(gt)
    fg_dil = _dilate(fg_boundary, bound_pix)
    gt_dil = _dilate(gt_boundary, bound_pix)

    gt_match = gt_boundary & fg_dil
    fg_match = fg_boundary & gt_dil

    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0
    precision = fg_match.sum() / n_fg
    recall = gt_match.sum() / n_gt
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def evaluate_sequence(pred_masks: List[np.ndarray], gt_masks: List[np.ndarray],
                      object_ids: List[int]) -> Dict[int, dict]:
    """Per-object J/F statistics over a sequence, excluding first and last frames
    (DAVIS protocol, reference evaluate_vos.py:47-100)."""
    results = {}
    for oid in object_ids:
        j_scores, f_scores = [], []
        for pred, gt in list(zip(pred_masks, gt_masks))[1:-1]:
            p = pred == oid
            g = gt == oid
            j_scores.append(binary_jaccard(p, g))
            f_scores.append(boundary_f_measure(p, g))
        j = np.asarray(j_scores) if j_scores else np.zeros(1)
        f = np.asarray(f_scores) if f_scores else np.zeros(1)

        def decay(t):
            # official DAVIS binning: 4 bins from linspace frame ids,
            # D = mean(bin1) - mean(bin4)
            ids = np.round(np.linspace(1, len(t), 5) + 1e-10).astype(int) - 1
            bins = [t[ids[i]:ids[i + 1] + 1] for i in range(4)]
            return float(max(np.mean(bins[0]) - np.mean(bins[3]), 0.0))

        results[oid] = {
            "J_mean": float(j.mean()), "J_recall": float((j > 0.5).mean()),
            "J_decay": decay(j),
            "F_mean": float(f.mean()), "F_recall": float((f > 0.5).mean()),
            "F_decay": decay(f),
        }
    return results


def evaluate_vos(trackers: List, dataset, report_name: str = "vos_report",
                 quiet: bool = False) -> dict:
    """Evaluate saved segmentation results over a VOS dataset (reference
    evaluate_vos.py:140-199). Returns {tracker_disp_name: {J&F-Mean, J-Mean, F-Mean}}."""
    from pytracking_tpu_torch.utils.png_io import imread_indexed

    all_results = OrderedDict()
    for trk in trackers:
        j_all, f_all = [], []
        for seq in dataset:
            seg_dir = os.path.join(trk.segmentation_dir, seq.name)
            if not os.path.isdir(seg_dir):
                continue
            names = [os.path.splitext(os.path.basename(f))[0]
                     for f in seq.frames]
            if len(set(names)) != len(names):
                # writer fallback for colliding frame names (running.py)
                names = [f"{i:05d}" for i in range(len(seq.frames))]
            preds, gts = [], []
            for name, gt in zip(names, seq.ground_truth_seg):
                path = os.path.join(seg_dir, name + ".png")
                if gt is None or not os.path.isfile(path):
                    continue
                preds.append(imread_indexed(path))
                gts.append(imread_indexed(gt) if isinstance(gt, str) else gt)
            if len(preds) < 3:
                if not quiet:
                    print(f"  [evaluate_vos] {seq.name}: no saved masks found "
                          f"under {seg_dir} — skipped")
                continue
            oids = [int(o) for o in (seq.object_ids or [1])]
            res = evaluate_sequence(preds, gts, oids)
            for oid, r in res.items():
                j_all.append(r["J_mean"])
                f_all.append(r["F_mean"])
        j_mean = float(np.mean(j_all)) if j_all else 0.0
        f_mean = float(np.mean(f_all)) if f_all else 0.0
        name = getattr(trk, "display_name", None) or f"{trk.name}_{trk.parameter_name}"
        all_results[name] = {"J&F-Mean": (j_mean + f_mean) / 2,
                             "J-Mean": j_mean, "F-Mean": f_mean}
        if not quiet:
            print(f"{name:<30s} J&F: {(j_mean + f_mean) / 2 * 100:.1f}  "
                  f"J: {j_mean * 100:.1f}  F: {f_mean * 100:.1f}")
    return all_results
