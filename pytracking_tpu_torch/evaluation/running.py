"""Track the sequences of a dataset and write the result files (counterpart
of pytracking_tpu/evaluation/running.py).

The files are the JAX package's (and upstream pytracking's), so the
analysis code of either package reads the results of either:
  <results_path>/<tracker>/<param>/<seq_name>.txt    boxes per frame, tab-separated ints
  <seq_name>_time.txt                                 seconds per frame
  <seq_name>_object_presence_scores.txt               presence scores
  multi-object: <seq_name>_<obj_id>.txt etc.; OxUvA: <video>_<object>.csv
  <segmentation_path>/<tracker>/<param>/<seq_name>/<frame>.png   label maps

A sequence that raises is reported and skipped unless `debug` is set, as
in the reference; the caller checks that the files it needs exist.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from pytracking_tpu_torch.evaluation.data import Sequence
from pytracking_tpu_torch.evaluation.multi_object_wrapper import mask_extent_box


def _read_image(path: str) -> np.ndarray:
    """A frame as (H, W, 3) RGB uint8: synthetic:// URIs are rendered, files
    read with OpenCV or PIL (the JAX package's fallback route; its native
    JPEG decoder is not ported yet)."""
    if path.startswith("synthetic://"):
        from pytracking_tpu_torch.evaluation.adapters.synthetic import load_synthetic_frame
        return load_synthetic_frame(path)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs OpenCV (cv2) or PIL, and neither is "
                          "installed; the synthetic datasets need neither") from e
    return np.asarray(Image.open(path).convert("RGB"))


# OxUvA long-term benchmark submission format
PREDICTION_FIELD_NAMES = ["video", "object", "frame_num", "present", "score",
                          "xmin", "xmax", "ymin", "ymax"]


def _save_tracker_output_oxuva(seq: Sequence, tracker, output: dict):
    """One CSV row per tracked frame: the box normalised by the image size
    as [xmin, xmax, ymin, ymax] and the presence decision, the presence
    score against the tracker's threshold."""
    import csv

    os.makedirs(tracker.results_dir, exist_ok=True)
    frame_names = [os.path.splitext(os.path.basename(f))[0] for f in seq.frames]
    img_h, img_w = output["image_shape"]
    bb = np.array(output["target_bbox"], np.float64)
    scores = np.array(output["object_presence_score"], np.float64)
    norm = np.stack([bb[:, 0] / img_w, (bb[:, 0] + bb[:, 2]) / img_w,
                     bb[:, 1] / img_h, (bb[:, 1] + bb[:, 3]) / img_h], axis=1).clip(0.0, 1.0)
    norm, scores = norm[1:], scores[1:]      # frame 0 is the init frame
    frame_numbers = [int(n) for n in frame_names[1:]]
    vid_id, obj_id = seq.name.split("_")[:2]
    thresh = output.get("object_presence_score_threshold", 0.55)
    pred_file = os.path.join(tracker.results_dir, f"{vid_id}_{obj_id}.csv")
    with open(pred_file, "w") as fp:
        writer = csv.DictWriter(fp, fieldnames=PREDICTION_FIELD_NAMES)
        for i, fnum in enumerate(frame_numbers):
            writer.writerow({
                "video": vid_id, "object": obj_id, "frame_num": fnum,
                "present": str(bool(scores[i] > thresh)).lower(),
                "score": scores[i],
                "xmin": norm[i, 0], "xmax": norm[i, 1],
                "ymin": norm[i, 2], "ymax": norm[i, 3],
            })


def _results_exist(tracker, seq: Sequence) -> bool:
    """Skip-if-done: every result file of the sequence is there."""
    if seq.dataset == "oxuva":
        vid_id, obj_id = seq.name.split("_")[:2]
        return os.path.isfile(os.path.join(tracker.results_dir, f"{vid_id}_{obj_id}.csv"))
    if seq.object_ids is None:
        return os.path.isfile(os.path.join(tracker.results_dir, f"{seq.name}.txt"))
    return all(os.path.isfile(os.path.join(tracker.results_dir, f"{seq.name}_{oid}.txt"))
               for oid in seq.object_ids)


def _by_object(data):
    by_obj = {}
    for frame in data:
        for oid, v in frame.items():
            by_obj.setdefault(oid, []).append(v)
    return by_obj


def _save_tracker_output(seq: Sequence, tracker, output: dict):
    """Write the result files. Boxes are truncated to ints (`astype(int)`,
    not rounded), as the reference writes them."""
    os.makedirs(tracker.results_dir, exist_ok=True)
    base = os.path.join(tracker.results_dir, seq.name)

    def save_bb(fname, data):
        np.savetxt(fname, np.array(data).astype(int), delimiter="\t", fmt="%d")

    def save_time(fname, data):
        np.savetxt(fname, np.array(data), delimiter="\t", fmt="%f")

    def save_score(fname, data):
        np.savetxt(fname, np.array(data).astype(float), delimiter="\t", fmt="%.2f")

    writers = {"target_bbox": ("", save_bb), "time": ("_time", save_time),
               "object_presence_score": ("_object_presence_scores", save_score)}
    for key, data in output.items():
        if not data:
            continue
        if key in writers:
            suffix, save = writers[key]
            if isinstance(data[0], dict):                   # multi-object
                for oid, d in _by_object(data).items():
                    save(f"{base}_{oid}{suffix}.txt", d)
            else:
                save(f"{base}{suffix}.txt", data)
        elif key == "segmentation":
            from pytracking_tpu_torch.utils.png_io import imwrite_indexed
            seg_dir = os.path.join(tracker.segmentation_dir, seq.name)
            os.makedirs(seg_dir, exist_ok=True)
            names = [os.path.splitext(os.path.basename(p))[0] for p in seq.frames]
            if len(set(names)) != len(names):   # synthetic:// URIs collide
                names = [f"{i:05d}" for i in range(len(seq.frames))]
            if len(data) == len(names) - 1:
                # no segmentation of the init frame: the masks start at frame 1
                names = names[1:]
            for name, seg in zip(names, data):
                imwrite_indexed(os.path.join(seg_dir, name + ".png"), seg)


def run_sequence(seq: Sequence, tracker, debug: int = 0,
                 profile_dir: Optional[str] = None) -> Optional[dict]:
    """Track one sequence and save its results; returns the outputs, or
    None where the results existed or the sequence failed (with
    `debug` set a failure raises). Each frame's time covers `track`, which
    ends in the frame's readback from the device; the first frame's covers
    building the tracker and `initialize`, whose device work the first
    `track` waits for.

    profile_dir: trace the sequence with torch.profiler (host and, on a
    card, device activity) into a TensorBoard / Chrome trace there."""
    if profile_dir:
        import torch

        os.makedirs(profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir)):
            out = run_sequence(seq, tracker, debug=debug)
        print(f"torch.profiler trace written to {profile_dir} "
              "(view: tensorboard --logdir <dir>, or chrome://tracing)")
        return out
    if debug == 0 and _results_exist(tracker, seq):
        print(f"FPS: {-1} -- skipping {seq.name}, results exist")
        return None

    output = {"target_bbox": [], "time": [], "object_presence_score": [], "segmentation": []}

    def track_frames():
        image = _read_image(seq.frames[0])
        output["image_shape"] = image.shape[:2]
        start = time.perf_counter()
        t = tracker.create_tracker(multiobj=seq.multiobj_mode)
        info = seq.init_info()
        output["object_presence_score_threshold"] = getattr(
            getattr(t, "params", None), "object_presence_score_threshold", 0.55)
        prev_output = t.initialize(image, info) or {}
        init_time = time.perf_counter() - start
        init_bbox = info.get("init_bbox")
        if init_bbox is None and info.get("init_mask") is not None:
            # objects given by their masks alone (DAVIS, YouTube-VOS): the
            # first row is each mask's extent, the box the trackers start from
            mask = np.asarray(info["init_mask"])
            init_bbox = mask_extent_box(mask) if seq.object_ids is None else {
                oid: mask_extent_box(mask == int(oid))
                for oid in info.get("object_ids", seq.object_ids)}
        if seq.object_ids is not None and not isinstance(init_bbox, dict):
            # multi-object outputs are dicts by object: so is frame 0
            init_bbox = {oid: init_bbox for oid in info.get("object_ids", seq.object_ids)}
        output["target_bbox"].append(init_bbox)
        output["time"].append(init_time)
        # presence 1.0 on the init frame keeps the score file row-aligned
        # with the box file
        init_presence = prev_output.get("object_presence_score")
        if init_presence is None:
            if seq.object_ids is not None:
                init_presence = {oid: 1.0 for oid in info.get("object_ids", seq.object_ids)}
            else:
                init_presence = 1.0
        output["object_presence_score"].append(init_presence)
        if "segmentation" in prev_output:
            output["segmentation"].append(prev_output["segmentation"])

        for frame_num, frame_path in enumerate(seq.frames[1:], start=1):
            image = _read_image(frame_path)
            start = time.perf_counter()
            info = seq.frame_info(frame_num)
            info["previous_output"] = prev_output
            out = t.track(image, info)
            prev_output = out
            output["time"].append(time.perf_counter() - start)
            output["target_bbox"].append(out["target_bbox"])
            if "object_presence_score" in out:
                output["object_presence_score"].append(out["object_presence_score"])
            if "segmentation" in out:
                output["segmentation"].append(out["segmentation"])

    try:
        track_frames()
    except Exception as e:  # one failing sequence does not stop the dataset
        if debug:
            raise
        print(f"Sequence {seq.name} crashed: {e!r} -- skipping")
        return None

    total = sum(output["time"])
    n = len(output["time"])
    print(f"Tracker: {tracker.name} {tracker.parameter_name} , "
          f"Sequence: {seq.name}, FPS: {n / max(total, 1e-9):.2f}")
    if seq.dataset == "oxuva":
        _save_tracker_output_oxuva(seq, tracker, output)
    else:
        _save_tracker_output(seq, tracker, output)
    return output


def _run_sequence_job(args):
    """A pool worker's job: rebuild the tracker from its name, parameter
    name, run id, device and precision, and run one sequence. Returns
    (pid, sequence name, the worker's peak device memory in bytes, None
    on the CPU)."""
    seq, tracker_info, debug = args
    import torch

    from pytracking_tpu_torch.evaluation.tracker import Tracker

    tracker = Tracker(**tracker_info)
    run_sequence(seq, tracker, debug=debug)
    peak = (torch.cuda.max_memory_allocated(tracker.device)
            if tracker.device.type == "cuda" else None)
    return os.getpid(), seq.name, peak


def run_dataset(dataset, trackers: List, debug: int = 0, threads: int = 0,
                shard: int = 0, num_shards: int = 1, profile_dir: Optional[str] = None):
    """Run every (sequence, tracker) job. `shard` / `num_shards` take every
    num_shards-th sequence. `threads > 0` runs the jobs in a pool of
    spawned processes (a CUDA context does not survive a fork), each
    building its own tracker and net on the tracker's device with the
    parent's precision choice; returns the jobs' (pid, sequence, peak
    device bytes). `profile_dir` traces the first sequence (threads = 0)."""
    seqs = [s for i, s in enumerate(dataset) if i % num_shards == shard]
    print(f"Evaluating {len(trackers)} trackers on {len(seqs)} sequences "
          f"(shard {shard}/{num_shards})")
    reports = None
    if threads > 0:
        import multiprocessing

        jobs = []
        for seq in seqs:
            for t in trackers:
                bf16, bf16_backbone = t.precision()
                jobs.append((seq, dict(name=t.name, parameter_name=t.parameter_name,
                                       run_id=t.run_id, display_name=t.display_name,
                                       device=str(t.device), bf16=bf16,
                                       bf16_backbone=bf16_backbone), debug))
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(threads) as pool:
            reports = pool.map(_run_sequence_job, jobs)
    else:
        for seq in seqs:
            for tracker in trackers:
                run_sequence(seq, tracker, debug=debug, profile_dir=profile_dir)
                profile_dir = None  # profile only the first sequence
    print("Done")
    return reports
