"""Dump a target candidate (distractor) file for KeepTrack's matching
training (counterpart of pytracking_tpu/util_scripts/create_distractor_dataset.py):
track every sequence of an evaluation dataset with a base tracker and
record, per tracked frame, its candidates ((y, x) image coordinates and
scores), the frame's state against the annotation, the matching
candidate's index, the search area (x, y, w, h) and the annotation, in one
JSON file that training/datasets/candidate_matching.py reads.

    python -m pytracking_tpu_torch.util_scripts.create_distractor_dataset \
        dimp super_dimp lasot_train /path/to/save_dir [--device cuda]

A tracker whose output has no 'candidates' (the port's SuperDiMP and
KeepTrack return the box, its score and a flag) gives one candidate at the
box's centre with score 1.0, and no 'search_area_box' a square of 6 times
the box's side (the square root of its area) around that centre. The file
is rewritten after each sequence, and a rerun skips the sequences it holds.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from pytracking_tpu_torch.evaluation.running import _read_image

STATES = ("invalid", "target_lost", "target_only", "target_with_distractors")


def load_dump_seq_data_from_disk(path):
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    return {}


def dump_seq_data_to_disk(save_path, seq_name, seq_data):
    d = load_dump_seq_data_from_disk(save_path)
    d[seq_name] = seq_data
    tmp = save_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(d, f)
    os.replace(tmp, save_path)


def determine_frame_state(candidates, gt_box, th: float = 0.25):
    """(state, index of the target's candidate or -1): 'invalid' without an
    annotation or a candidate; 'target_lost' where no candidate within half
    the box's diagonal of its centre scores above th; else the best such
    candidate, and 'target_with_distractors' where another candidate
    scores above th, 'target_only' where none does."""
    scores = np.asarray(candidates["scores"])
    coords = np.asarray(candidates["coords"], np.float32)
    if gt_box is None or np.any(np.asarray(gt_box) < 0) or len(scores) == 0:
        return "invalid", -1
    cx = gt_box[0] + gt_box[2] / 2
    cy = gt_box[1] + gt_box[3] / 2
    d = np.hypot(coords[:, 1] - cx, coords[:, 0] - cy)
    radius = max(float(np.hypot(gt_box[2], gt_box[3])) / 2, 1.0)
    matches = d < radius
    if not np.any(matches & (scores > th)):
        return "target_lost", -1
    idx = int(np.argmax(np.where(matches, scores, -np.inf)))
    num_distractors = int(np.sum((scores > th) & ~matches))
    return ("target_with_distractors" if num_distractors > 0 else "target_only"), idx


def extract_candidate_data(tracker, seq):
    """{frame index (str): candidate record} of every frame after the first
    of `seq`, tracked by `tracker` (initialised on the first)."""
    tracker.initialize(_read_image(seq.frames[0]), seq.init_info())
    seq_data = {}
    for i, frame_path in enumerate(seq.frames[1:], start=1):
        out = tracker.track(_read_image(frame_path))
        cand = out.get("candidates")
        if cand is None:
            bb = out["target_bbox"]
            cand = {"coords": [[bb[1] + bb[3] / 2, bb[0] + bb[2] / 2]],
                    "scores": [float(out.get("score", 1.0))]}
        gt = seq.ground_truth_rect[i] if seq.ground_truth_rect is not None and \
            i < len(seq.ground_truth_rect) else None
        state, match_idx = determine_frame_state(cand, gt)
        sa = out.get("search_area_box")
        if sa is None:
            bb = np.asarray(out["target_bbox"], np.float32)
            sz = float(np.sqrt(max(bb[2] * bb[3], 1.0))) * 6.0
            sa = [bb[0] + bb[2] / 2 - sz / 2, bb[1] + bb[3] / 2 - sz / 2, sz, sz]
        seq_data[str(i)] = {
            "coords": np.asarray(cand["coords"], np.float32).tolist(),
            "scores": np.asarray(cand["scores"], np.float32).tolist(),
            "state": state, "match_idx": match_idx,
            "search_area_box": np.asarray(sa, np.float32).tolist(),
            "anno": None if gt is None else np.asarray(gt, np.float32).tolist(),
        }
    return seq_data


def run_tracker(tracker_name, parameter_name, dataset_name, save_dir, device="cuda"):
    """Dump `dataset_name`'s sequences tracked by tracker_name /
    parameter_name on `device` (the card by default; without one it raises)
    into <save_dir>/target_candidates_dataset_<tracker>_<param>.json;
    returns the file's path."""
    from pytracking_tpu_torch.evaluation.datasets import get_dataset
    from pytracking_tpu_torch.evaluation.tracker import Tracker

    wrapper = Tracker(tracker_name, parameter_name, device=device)
    os.makedirs(save_dir, exist_ok=True)
    save_path = os.path.join(
        save_dir, f"target_candidates_dataset_{tracker_name}_{parameter_name}.json")
    done = load_dump_seq_data_from_disk(save_path)
    for seq in get_dataset(dataset_name):
        if seq.name in done:
            continue
        seq_data = extract_candidate_data(wrapper.create_tracker(), seq)
        dump_seq_data_to_disk(save_path, seq.name, seq_data)
        print(f"{seq.name}: {len(seq_data)} frames", flush=True)
    print(f"Saved to {save_path}", flush=True)
    return save_path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Dump target candidate data for KeepTrack's matching training.")
    parser.add_argument("tracker_name", type=str)
    parser.add_argument("parameter_name", type=str)
    parser.add_argument("dataset_name", type=str)
    parser.add_argument("save_dir", type=str)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    run_tracker(args.tracker_name, args.parameter_name, args.dataset_name, args.save_dir,
                args.device)


if __name__ == "__main__":
    main()
