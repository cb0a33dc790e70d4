#!/usr/bin/env python3
"""Checks of a seeded KeepTrack tracker (parameter/keep_track/default or
default_fast, seed 0) on chip_smoke.py's synthetic sequence, on the card.

    python3 scripts/keep_track_check.py scores [default|default_fast] [nf:cand ...]
    python3 scripts/keep_track_check.py stages [default|default_fast] [frames]

scores: for each (not-found threshold, candidate threshold) pair (the
module's own first, then the ones given as `nf:cand`), `initialize` +
chip_smoke's frames of the device association; prints DiMP's score peak
(min / median / max), the number of local maxima (5x5) above several
thresholds per frame, the flag histogram, the valid candidates per frame,
the frames on which the association assigned a new object id and the lost
frames that rescaled the search area. Random weights put the peaks far
below a trained net's; this shows which cuts exercise the association.

stages: where a tracked frame's time goes, by stage (backbone,
classification, DiMP's localisation, the candidates, the matching net's
backbone, descriptors and matcher, the association, the search-area
rescaling, box refinement, memory update, classifier refit, the rest):
host time, device kernel time and kernel launches per frame under
torch.profiler, after chip_smoke's frames, at chip_smoke's cuts.
"""

import collections
import dataclasses
import importlib
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dimp_check import dimp_stage_table, profile_stages  # noqa: E402
from pytracking_tpu_torch.trackers import keep_track as t_kt  # noqa: E402

FRAMES = {"default": chip_smoke.KEEP_TRACK_FRAMES, "default_fast": chip_smoke.SHORT_FRAMES}
PEAK_THRESHOLDS = (0.1, 0.05, 0.02, 0.01, 0.0, -1.0)


def _param_name(args):
    if args and args[0] in FRAMES:
        return args[0], args[1:]
    return "default", args


def _frames(n):
    bg = np.random.RandomState(0).randint(0, 90, (480, 640, 3)).astype(np.uint8)
    return [chip_smoke.dimp_frame(bg, t) for t in range(n + 1)]


def scores(args):
    name, args = _param_name(args)
    module = importlib.import_module(f"pytracking_tpu_torch.parameter.keep_track.{name}")
    base = module.params()
    settings = [(base.target_not_found_threshold, base.local_max_candidate_score_th)] + \
        [tuple(float(v) for v in a.split(":")) for a in args]
    spec = chip_smoke.keep_track_spec(name)
    frames = _frames(FRAMES[name])
    maps = []
    top_k = t_kt.top_k_peaks

    def recording(s, k, th):
        maps.append(s)
        return top_k(s, k, th)

    t_kt.top_k_peaks = recording
    for nf, cand in settings:
        params = dataclasses.replace(spec.params, target_not_found_threshold=nf,
                                     local_max_candidate_score_th=cand)
        tracker = t_kt.KeepTrackTracker(params, spec.net, device="cuda", **spec.tracker_kwargs)
        tracker.initialize(frames[0], chip_smoke.DIMP_INIT)
        maps.clear()
        outs, before, after = [], [], []
        names = ("assoc_active", "assoc_id_cntr", "scale_history_n", "prev_cand_valid")
        for im in frames[1:]:
            before.append({k: getattr(tracker.state, k) for k in names})
            outs.append(tracker.track(im))
            after.append({k: getattr(tracker.state, k) for k in names})
        peaks = np.asarray([float(m.max()) for m in maps])
        counts = {th: [] for th in PEAK_THRESHOLDS}
        for m in maps:
            peak = m == F.max_pool2d(m[None, None], 5, stride=1, padding=2)[0, 0]
            for th in PEAK_THRESHOLDS:
                counts[th].append(int((peak & (m > th)).sum()))
        new_id = [i + 1 for i, (b, a) in enumerate(zip(before, after))
                  if bool(b["assoc_active"]) and bool(a["assoc_active"])
                  and int(a["assoc_id_cntr"]) > int(b["assoc_id_cntr"])]
        rescaled = [i + 1 for i, (b, o) in enumerate(zip(before, outs))
                    if o["flag"] == "not_found" and int(b["scale_history_n"]) > 0]
        print(f"{name} not-found {nf} candidates {cand}: DiMP peaks (min, median, max) "
              f"({peaks.min():.4f}, {np.median(peaks):.4f}, {peaks.max():.4f}); local maxima "
              f"per frame (min/median/max) "
              + ", ".join(f"> {th}: {min(c)}/{int(np.median(c))}/{max(c)}"
                          for th, c in counts.items())
              + f"; flags {dict(collections.Counter(o['flag'] for o in outs))}; valid "
              f"candidates {dict(sorted(collections.Counter(int(a['prev_cand_valid'].sum()) for a in after).items()))}; "
              f"new ids on {len(new_id)} frames {new_id[:8]}; lost frames rescaled "
              f"{len(rescaled)} {rescaled[:8]}; peaks of frames 1-10 "
              f"{[round(x, 4) for x in peaks[:10].tolist()]}", flush=True)


def stages(args):
    name, args = _param_name(args)
    n = int(args[0]) if args else 5
    spec = chip_smoke.keep_track_spec(name)
    tracker = t_kt.KeepTrackTracker(spec.params, spec.net, device="cuda", **spec.tracker_kwargs)
    tcm = tracker.tcm_net
    table = dimp_stage_table(tracker)
    del table["memory update"], table["classifier refit"]
    table.update({
        "candidates (top-K peaks)": (t_kt, "top_k_peaks"),
        "matching backbone": (tcm, "extract_backbone"),
        "descriptors": (tcm, "get_descriptors"),
        "matcher (GNN, Sinkhorn)": (tcm, "match"),
        "association": (tracker, "_associate_device"),
        "search-area rescaling": (tracker, "_rescale_search_area"),
        "memory update": (tracker, "_update_memory_certainty"),
        "classifier refit": (tracker, "_update_classifier_certainty"),
    })
    frames = _frames(FRAMES[name] + n)
    tracker.initialize(frames[0], chip_smoke.DIMP_INIT)
    profile_stages(tracker, table, frames[1:FRAMES[name] + 1], frames[FRAMES[name] + 1:],
                   f"keep_track {name}")


def main():
    if not torch.cuda.is_available():
        print("keep_track_check: needs a CUDA card", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else "scores"
    {"scores": scores, "stages": stages}[mode](sys.argv[2:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
