"""Score tables from extracted results (the tables of
pytracking_tpu/analysis/plot_results.py, with the same numbers): AUC, OP50,
OP75, precision and normalised precision per tracker and per attribute.
The per-sequence table and the matplotlib plots are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pytracking_tpu_torch.analysis.extract_results import extract_results

SCORE_NAMES = ("AUC", "OP50", "OP75", "Precision", "Norm Precision")


def get_scores(eval_data: dict) -> dict:
    """AUC / OP50 / OP75 / Precision / Norm Precision per tracker, in
    percent, and the success and precision curves."""
    valid = np.asarray(eval_data["valid_sequence"], bool)
    succ = np.asarray(eval_data["ave_success_rate_plot_overlap"])[valid] * 100.0
    prec = np.asarray(eval_data["ave_success_rate_plot_center"])[valid] * 100.0
    prec_norm = np.asarray(eval_data["ave_success_rate_plot_center_norm"])[valid] * 100.0
    thr_ov = np.asarray(eval_data["threshold_set_overlap"])

    auc_curve = succ.mean(0)                      # (trackers, thresholds)
    auc = auc_curve.mean(-1)
    op50 = auc_curve[:, np.abs(thr_ov - 0.50).argmin()]
    op75 = auc_curve[:, np.abs(thr_ov - 0.75).argmin()]
    prec_curve = prec.mean(0)
    prec_score = prec_curve[:, 20]
    norm_curve = prec_norm.mean(0)
    norm_score = norm_curve[:, np.abs(np.asarray(
        eval_data["threshold_set_center_norm"]) - 0.20).argmin()]

    return {"AUC": auc, "OP50": op50, "OP75": op75, "Precision": prec_score,
            "Norm Precision": norm_score,
            "success_curve": auc_curve, "precision_curve": prec_curve}


def print_results(trackers: List, dataset, report_name: str = "report", **kwargs) -> dict:
    """Print the score table; returns the scores (`get_scores`)."""
    eval_data = extract_results(trackers, dataset, report_name, **kwargs)
    scores = get_scores(eval_data)
    names = [t["disp_name"] for t in eval_data["trackers"]]

    header = f"{'Tracker':<30s}" + "".join(f"{k:>16s}" for k in SCORE_NAMES)
    print("-" * len(header))
    print(header)
    print("-" * len(header))
    for i, name in enumerate(names):
        print(f"{name:<30s}" + "".join(f"{scores[k][i]:>16.2f}" for k in SCORE_NAMES))
    print("-" * len(header))
    return scores


def print_per_attribute_results(trackers: List, dataset, report_name: str = "report",
                                attribute_specs: Optional[dict] = None, **kwargs):
    """Print the AUC per attribute (or scenario) of the sequences'
    `attributes`; `attribute_specs` maps a code to its display name.
    Returns {attribute: {tracker_disp_name: auc}}, or None without
    attributes."""
    attr_of = {}
    for seq in dataset:
        for a in getattr(seq, "attributes", []) or []:
            attr_of.setdefault(a, []).append(seq.name)
    if not attr_of:
        print("No attribute annotations in this dataset")
        return None

    eval_data = extract_results(trackers, dataset, report_name, **kwargs)
    succ = np.asarray(eval_data["ave_success_rate_plot_overlap"]) * 100.0
    names = [t["disp_name"] for t in eval_data["trackers"]]
    seq_index = {n: i for i, n in enumerate(eval_data["sequences"])}

    attrs = sorted(attr_of)
    disp = [(attribute_specs or {}).get(a, a) for a in attrs]
    width = max(22, max(len(d) for d in disp) + 2)
    print(f"{'Scenario':<{width}s}{'#seq':>6s}" + "".join(f"{n:>16s}" for n in names))
    table = {}
    for a, d in zip(attrs, disp):
        ids = [seq_index[s] for s in attr_of[a] if s in seq_index]
        if not ids:
            continue
        aucs = succ[ids].mean(0).mean(-1)
        table[a] = dict(zip(names, aucs.tolist()))
        print(f"{d:<{width}s}{len(ids):>6d}" + "".join(f"{v:>16.1f}" for v in aucs))
    return table
