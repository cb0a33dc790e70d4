"""Per-frame errors and success / precision statistics from result files
(counterpart of pytracking_tpu/analysis/extract_results.py, with the same
numbers). Reads the .txt files written by evaluation/running.py (either
package's), computes the IoU overlap and centre errors per frame with the
reference's robustness rules, and pickles `eval_data.pkl` under
`result_plot_path/<report_name>`.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np


def calc_err_center(pred_bb: np.ndarray, anno_bb: np.ndarray, normalized=False):
    """Center error per frame (reference extract_results.py:17-26)."""
    pred_center = pred_bb[:, :2] + 0.5 * (pred_bb[:, 2:] - 1.0)
    anno_center = anno_bb[:, :2] + 0.5 * (anno_bb[:, 2:] - 1.0)
    if normalized:
        pred_center = pred_center / anno_bb[:, 2:]
        anno_center = anno_center / anno_bb[:, 2:]
    return np.sqrt(((pred_center - anno_center) ** 2).sum(1))


def calc_iou_overlap(pred_bb: np.ndarray, anno_bb: np.ndarray) -> np.ndarray:
    """IoU per frame (reference extract_results.py:29-38)."""
    tl = np.maximum(pred_bb[:, :2], anno_bb[:, :2])
    br = np.minimum(pred_bb[:, :2] + pred_bb[:, 2:] - 1.0,
                    anno_bb[:, :2] + anno_bb[:, 2:] - 1.0)
    sz = np.clip(br - tl + 1.0, 0, None)
    intersection = sz.prod(axis=1)
    union = pred_bb[:, 2:].prod(axis=1) + anno_bb[:, 2:].prod(axis=1) - intersection
    return intersection / np.maximum(union, 1e-12)


def calc_seq_err_robust(pred_bb: np.ndarray, anno_bb: np.ndarray, dataset: str,
                        target_visible: Optional[np.ndarray] = None):
    """Per-frame errors with per-dataset robustness rules
    (reference extract_results.py:41-100). Returns FULL-length error arrays plus the
    per-frame validity mask; invalid frames carry the reference's sentinel values
    (overlap -1, center inf, norm-center -1; uav center -1; lasot occluded inf)."""
    pred_bb = np.asarray(pred_bb, np.float64).copy()
    anno_bb = np.asarray(anno_bb, np.float64)

    if np.isnan(pred_bb).any() or (pred_bb[:, 2:] < 0.0).any():
        raise Exception("Error: Invalid results")
    if np.isnan(anno_bb).any() and dataset != "uav":
        raise Exception("Warning: NaNs in annotation")

    # zero-size predictions ("target lost"): carry the previous frame's box
    # forward (reference :54-57)
    if (pred_bb[:, 2:] == 0.0).any():
        for i in range(1, pred_bb.shape[0]):
            if (pred_bb[i, 2:] == 0.0).any() and not np.isnan(anno_bb[i, :]).any():
                pred_bb[i, :] = pred_bb[i - 1, :]

    # prediction/annotation length mismatch (reference :59-72)
    if pred_bb.shape[0] != anno_bb.shape[0]:
        if pred_bb.shape[0] > anno_bb.shape[0]:
            pred_bb = pred_bb[:anno_bb.shape[0], :]
        elif dataset == "lasot":
            raise Exception("Mis-match in tracker prediction and GT lengths")
        else:
            pad = np.zeros((anno_bb.shape[0] - pred_bb.shape[0], 4), np.float64)
            pred_bb = np.concatenate([pred_bb, pad], axis=0)

    pred_bb[0, :] = anno_bb[0, :]

    if target_visible is not None:
        target_visible = np.asarray(target_visible).astype(bool)
        valid = ((anno_bb > 0.0).sum(1) == 4) & target_visible
    else:
        valid = (anno_bb > 0.0).sum(1) == 4

    with np.errstate(divide="ignore", invalid="ignore"):
        err_center = calc_err_center(pred_bb, anno_bb)
        err_center_normalized = calc_err_center(pred_bb, anno_bb, normalized=True)
        err_overlap = calc_iou_overlap(pred_bb, anno_bb)

    # invalid-annotation sentinels (reference :86-96)
    err_center[~valid] = -1.0 if dataset == "uav" else np.inf
    err_center_normalized[~valid] = -1.0
    err_overlap[~valid] = -1.0

    if dataset == "lasot" and target_visible is not None:
        err_center_normalized[~target_visible] = np.inf
        err_center[~target_visible] = np.inf

    if np.isnan(err_overlap).any():
        raise Exception("Nans in calculated overlap")
    return err_overlap, err_center, err_center_normalized, valid


def extract_results_prec_rec_f1(trackers: List, dataset,
                                report_name: Optional[str] = None,
                                skip_missing_seq: bool = False,
                                anno_period: int = 1) -> dict:
    """Precision/recall/F1 over presence scores (reference
    extract_results.py:186-290; the LaGOT benchmark's metric): frames of ALL
    sequences pooled, sorted by the tracker's object-presence score; recall uses
    cumulative overlap over visible frames, precision over reported frames; F1 is
    maximized over the score threshold."""
    from pytracking_tpu_torch.evaluation.environment import env_settings
    settings = env_settings()

    valid_sequence = np.ones(len(dataset), dtype=bool)
    raw_data = {}
    for trk in trackers:
        pred_all, anno_all, vis_all, scores_all = [], [], [], []
        for seq_id, seq in enumerate(dataset):
            anno_bb = np.asarray(seq.ground_truth_rect, np.float64)
            target_visible = (np.asarray(seq.target_visible)
                              if seq.target_visible is not None
                              else np.ones(len(anno_bb)))
            base = os.path.join(trk.results_dir, seq.name)
            results_path = f"{base}.txt"
            scores_path = f"{base}_object_presence_scores.txt"
            if not os.path.isfile(results_path):
                if skip_missing_seq:
                    valid_sequence[seq_id] = False
                    break
                raise FileNotFoundError(f"Result not found: {results_path}")
            pred_bb = np.loadtxt(results_path, delimiter="\t", ndmin=2)
            if os.path.isfile(scores_path):
                scores = np.loadtxt(scores_path, ndmin=1)
            else:
                scores = np.ones(pred_bb.shape[0])
            pred_all.append(pred_bb[::anno_period])
            anno_all.append(anno_bb[::anno_period])
            vis_all.append(target_visible[::anno_period])
            scores_all.append(scores[::anno_period])

        pred_cat = np.concatenate(pred_all, 0)
        anno_cat = np.concatenate(anno_all, 0)
        vis_cat = np.concatenate(vis_all, 0)
        scores_cat = np.concatenate(scores_all, 0).astype(np.float64)

        err_overlap, _, _, valid_frame = calc_seq_err_robust(
            pred_cat, anno_cat, dataset[0].dataset, vis_cat)

        ind = np.argsort(-scores_cat, kind="stable")
        scores_sorted = scores_cat[ind]
        overlap_sorted = err_overlap[ind].copy()
        overlap_sorted[~valid_frame[ind]] = 0.0
        overlap_acc = np.cumsum(overlap_sorted)

        den_rec = max(valid_frame.sum(), 1)
        den_prec = np.arange(1, scores_sorted.shape[0] + 1, dtype=np.float64)
        rec = np.concatenate([[0.0], overlap_acc / den_rec])
        prec = np.concatenate([[1.0], overlap_acc / den_prec])
        with np.errstate(invalid="ignore"):
            f1 = 2 * prec * rec / (prec + rec)
        f1 = np.nan_to_num(f1)
        idx = int(np.argmax(f1))
        key = getattr(trk, "display_name", None) or \
            f"{trk.name}_{trk.parameter_name}"
        if trk.run_id is not None:
            key = f"{key}_{trk.run_id}"
        raw_data[key] = {
            "prec": prec, "rec": rec, "f1_max": float(f1[idx]),
            "ths_max": float(scores_sorted[min(idx, len(scores_sorted) - 1)]),
            "idx": idx,
        }

    eval_data = {
        "sequences": [s.name for s in dataset],
        "trackers": [{"name": t.name, "param": t.parameter_name,
                      "run_id": t.run_id,
                      "disp_name": getattr(t, "display_name", None) or
                      f"{t.name}_{t.parameter_name}"} for t in trackers],
        "valid_sequence": valid_sequence.tolist(),
        "raw_data": raw_data,
    }
    if report_name is not None:
        out_dir = os.path.join(settings.result_plot_path, report_name)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "eval_data.pkl"), "wb") as f:
            pickle.dump(eval_data, f)
    return eval_data


def print_results_prec_rec_f1(trackers: List, dataset,
                              report_name: str = "prec_rec_f1", **kwargs) -> dict:
    """Print the LaGOT-style F1/Pr/Re table (reference plot_results.py
    print_prec_rec_curves usage)."""
    eval_data = extract_results_prec_rec_f1(trackers, dataset, report_name,
                                            **kwargs)
    print(f"{'Tracker':40s} {'F1':>8s} {'Pr@max':>8s} {'Re@max':>8s} {'ths':>8s}")
    scores = {}
    for key, d in eval_data["raw_data"].items():
        i = d["idx"]
        print(f"{key:40s} {d['f1_max']*100:8.2f} {d['prec'][i]*100:8.2f} "
              f"{d['rec'][i]*100:8.2f} {d['ths_max']:8.3f}")
        scores[key] = {"F1": d["f1_max"], "Pr": d["prec"][i], "Re": d["rec"][i]}
    return scores


def extract_results(trackers: List, dataset, report_name: Optional[str] = None,
                    skip_missing_seq: bool = False,
                    plot_bin_gap: float = 0.05,
                    exclude_invalid_frames: bool = False) -> dict:
    """Compute success/precision statistics for every (sequence, tracker)
    (reference extract_results.py:103-183). Returns (and optionally pickles) the
    eval_data dict used by plot_results/print_results."""
    from pytracking_tpu_torch.evaluation.environment import env_settings
    settings = env_settings()

    threshold_set_overlap = np.arange(0.0, 1.0 + plot_bin_gap, plot_bin_gap)
    threshold_set_center = np.arange(0, 51, 1, dtype=np.float64)
    threshold_set_center_norm = np.arange(0, 51, 1, dtype=np.float64) / 100.0

    avg_overlap_all = np.zeros((len(dataset), len(trackers)))
    ave_success_rate_plot_overlap = np.zeros((len(dataset), len(trackers),
                                              threshold_set_overlap.size))
    ave_success_rate_plot_center = np.zeros((len(dataset), len(trackers),
                                             threshold_set_center.size))
    ave_success_rate_plot_center_norm = np.zeros((len(dataset), len(trackers),
                                                  threshold_set_center.size))
    valid_sequence = np.ones(len(dataset), dtype=bool)

    for seq_id, seq in enumerate(dataset):
        anno_bb = np.asarray(seq.ground_truth_rect)
        target_visible = seq.target_visible
        for trk_id, trk in enumerate(trackers):
            base_results_path = os.path.join(trk.results_dir, seq.name)
            results_path = f"{base_results_path}.txt"
            if os.path.isfile(results_path):
                pred_bb = np.loadtxt(results_path, delimiter="\t")
                if pred_bb.ndim == 1:
                    pred_bb = pred_bb[None]
            elif skip_missing_seq:
                valid_sequence[seq_id] = False
                break
            else:
                raise FileNotFoundError(f"Result not found: {results_path}")

            err_overlap, err_center, err_center_norm, valid_frame = calc_seq_err_robust(
                pred_bb, anno_bb, seq.dataset, target_visible)

            avg_overlap_all[seq_id, trk_id] = (
                err_overlap[valid_frame].mean() if valid_frame.any() else 0.0)
            # curves over the FULL sequence, normalized by seq length (reference
            # :151-162): invalid frames carry failure sentinels from
            # calc_seq_err_robust, success uses strict >, precision uses <=
            seq_length = int(valid_frame.sum()) if exclude_invalid_frames \
                else anno_bb.shape[0]
            if seq_length <= 0:
                raise Exception("Seq length zero")
            ave_success_rate_plot_overlap[seq_id, trk_id] = \
                (err_overlap[:, None] > threshold_set_overlap[None]).sum(0) / seq_length
            ave_success_rate_plot_center[seq_id, trk_id] = \
                (err_center[:, None] <= threshold_set_center[None]).sum(0) / seq_length
            ave_success_rate_plot_center_norm[seq_id, trk_id] = \
                (err_center_norm[:, None] <= threshold_set_center_norm[None]).sum(0) / seq_length

    eval_data = {
        "sequences": [s.name for s in dataset],
        "trackers": [{"name": t.name, "param": t.parameter_name,
                      "run_id": t.run_id,
                      "disp_name": getattr(t, "display_name", None) or
                      f"{t.name}_{t.parameter_name}"} for t in trackers],
        "valid_sequence": valid_sequence.tolist(),
        "ave_success_rate_plot_overlap": ave_success_rate_plot_overlap.tolist(),
        "ave_success_rate_plot_center": ave_success_rate_plot_center.tolist(),
        "ave_success_rate_plot_center_norm": ave_success_rate_plot_center_norm.tolist(),
        "avg_overlap_all": avg_overlap_all.tolist(),
        "threshold_set_overlap": threshold_set_overlap.tolist(),
        "threshold_set_center": threshold_set_center.tolist(),
        "threshold_set_center_norm": threshold_set_center_norm.tolist(),
    }

    if report_name is not None:
        out_dir = os.path.join(settings.result_plot_path, report_name)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "eval_data.pkl"), "wb") as f:
            pickle.dump(eval_data, f)
    return eval_data
