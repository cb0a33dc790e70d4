#!/usr/bin/env python3
"""Checks of the seeded KYS tracker (parameter/kys/default, seed 0) on
chip_smoke.py's synthetic sequence, on the card.

    python3 scripts/kys_check.py scores [fused[:dimp] ...]
    python3 scripts/kys_check.py stages [frames]

scores: for each pair of fused not-found threshold and DiMP-score
threshold (below which the fused response is zeroed; the module's own pair
first, then the ones given, the DiMP threshold the module's where left
out), `initialize` + 110 frames; prints the fused response's peak and the
DiMP score's peak (min / median / max over the frames), the flag
histogram, the previous-frame alignment per frame (none, centre shift,
sub-pixel) and the frame from which the propagation state is valid.
Random weights put the peaks far from a trained net's; this shows which
thresholds give found and not_found frames on this sequence.

stages: where a tracked frame's time goes, by stage of the step (backbone,
classification, the previous frame's alignment, cost volume, response
predictor, fused localisation, box refinement, memory update, classifier
refit, the rest): host time, device kernel time and kernel launches per
frame under torch.profiler, over a few frames after chip_smoke.py's 110,
at chip_smoke's fused threshold.
"""

import collections
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dimp_check import dimp_stage_table, profile_stages  # noqa: E402
from pytracking_tpu_torch.models.tracking import kysnet as t_kysnet  # noqa: E402
from pytracking_tpu_torch.parameter.kys import default  # noqa: E402
from pytracking_tpu_torch.trackers import kys as t_kys  # noqa: E402


def _frames(n):
    bg = np.random.RandomState(0).randint(0, 90, (480, 640, 3)).astype(np.uint8)
    return [chip_smoke.dimp_frame(bg, t) for t in range(n + 1)]


def scores(args):
    spec = chip_smoke.kys_spec()
    base = default.params()
    settings = [(base.target_not_found_threshold_fused, base.dimp_threshold)]
    for a in args:
        v = [float(x) for x in a.split(":")]
        settings.append((v[0], v[1] if len(v) > 1 else base.dimp_threshold))
    frames = _frames(chip_smoke.N_FRAMES)
    for thr, dimp_thr in settings:
        params = dataclasses.replace(spec.params, target_not_found_threshold_fused=thr,
                                     dimp_threshold=dimp_thr)
        tracker = t_kys.KYSTracker(params, spec.net, device="cuda")
        dimp_peaks = []
        localize = tracker._localize_fused_streams

        def recording(state, fused, dimp_win, dimp_raw, *a, localize=localize):
            dimp_peaks.append(dimp_raw.max())
            return localize(state, fused, dimp_win, dimp_raw, *a)

        tracker._localize_fused_streams = recording
        tracker.initialize(frames[0], chip_smoke.DIMP_INIT)
        outs, before, valid = [], [], []
        for im in frames[1:]:
            before.append((tracker.state.have_state, tracker.state.prev_box_patch))
            outs.append(tracker.track(im))
            valid.append(tracker.state.have_state)
        fused = np.asarray([o["max_score"] for o in outs])
        dimp = torch.stack(dimp_peaks).cpu().numpy()
        branches = [chip_smoke.kys_branch(bool(h), b.tolist(), params) for h, b in before]
        valid_from = next((i + 1 for i, v in enumerate(valid) if bool(v)), None)
        print(f"kys fused threshold {thr}, DiMP threshold {dimp_thr}: fused peaks (min, median, "
              f"max) ({fused.min():.5f}, "
              f"{np.median(fused):.5f}, {fused.max():.5f}); DiMP peaks ({dimp.min():.4f}, "
              f"{np.median(dimp):.4f}, {dimp.max():.4f}); flags "
              f"{dict(collections.Counter(o['flag'] for o in outs))}; alignment "
              f"{dict(collections.Counter(branches))}; state valid from frame {valid_from}; "
              f"fused peaks of frames 1-12 {[round(x, 5) for x in fused[:12].tolist()]}; last "
              f"box {[round(x, 1) for x in outs[-1]['target_bbox']]}", flush=True)
        # per frame: n normal, x not_found, h hard negative, upper case where
        # the previous frame was aligned by the centre shift
        letter = {"normal": "n", "not_found": "x", "hard_negative": "h", "uncertain": "u"}
        print("  frames: " + "".join(
            letter[o["flag"]].upper() if b == "center" else letter[o["flag"]]
            for o, b in zip(outs, branches)), flush=True)


def stages(args):
    n = int(args[0]) if args else 5
    spec = chip_smoke.kys_spec()
    tracker = t_kys.KYSTracker(spec.params, spec.net, device="cuda")
    table = dimp_stage_table(tracker)
    del table["localisation"]
    table.update({
        "previous-frame alignment (shift_features)": (t_kys, "shift_features"),
        "cost volume": (t_kysnet, "cost_volume_abs"),
        "response predictor": (tracker.net.predictor, "forward"),
        "fused localisation": (tracker, "_localize_fused_streams"),
    })
    frames = _frames(chip_smoke.N_FRAMES + n)
    tracker.initialize(frames[0], chip_smoke.DIMP_INIT)
    profile_stages(tracker, table, frames[1:chip_smoke.N_FRAMES + 1],
                   frames[chip_smoke.N_FRAMES + 1:], "kys")


def main():
    if not torch.cuda.is_available():
        print("kys_check: needs a CUDA card", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else "scores"
    {"scores": scores, "stages": stages}[mode](sys.argv[2:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
