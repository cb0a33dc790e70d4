#!/usr/bin/env python3
"""Checks of the seeded LWL and RTS trackers (parameter/lwl/lwl_ytvos,
parameter/rts/rts50, seed 0) on chip_smoke.py's synthetic VOS sequence
(480x854, two objects), on the card.

    python3 scripts/lwl_check.py scores [auto] [nf:too_small ...]
    python3 scripts/lwl_check.py stages [lwl|multi|rts] [frames]

scores: LWL-YTVOS from object 1's mask over chip_smoke's 60 frames: mask
areas, IoU with the ground truth, the previous-frame probability mass
against min_mask_area. Then RTS-50 from object 1's box (STA's first mask)
over 60 frames, never lost (thresholds -inf): the classifier's peak per
frame; then at each given pair of not-found and too-small thresholds (and
chip_smoke's; with `auto` also pairs at quantiles of those peaks): the lost
counter per frame, the refits of each kind. Random
weights put the peaks far from a trained net's; this shows which cuts give
found, lost and re-found frames on this sequence.

stages: where a tracked frame's time goes, by stage of the step (backbone
to layer4, target-model features, label encoding of the memory, filter
update, decoder, paste, the mask-to-box step, memory update, readback, and
for RTS the classifier's parts; `multi` is LWL on both objects in one
batched step, with the device merge): host time, device kernel time and
kernel launches per frame under torch.profiler, over a few frames after
chip_smoke.py's phase.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dimp_check import profile_stages  # noqa: E402
from pytracking_tpu_torch.trackers.lwl import LWLMultiObjectTracker, LWLTracker  # noqa: E402
from pytracking_tpu_torch.trackers.rts import RTSTracker  # noqa: E402


def _sequence(n):
    bg = chip_smoke.vos_background()
    return [chip_smoke.vos_frame(bg, t) for t in range(n + 1)]


def _rts_run(spec, seq, nf, too_small):
    import dataclasses

    params = dataclasses.replace(spec.params, clf_target_not_found_threshold=nf,
                                 clf_target_not_found_threshold_too_small=too_small)
    tracker = RTSTracker(params, spec.net, device="cuda", **spec.tracker_kwargs)
    sta_out = []
    sta_mask = tracker._sta_predict_mask

    def recording(im, bbox):
        fwd = tracker.sta_net.forward
        tracker.sta_net.forward = lambda *a: sta_out.append(fwd(*a)) or sta_out[-1]
        try:
            return sta_mask(im, bbox)
        finally:
            del tracker.sta_net.forward

    tracker._sta_predict_mask = recording
    mask_refits, clf_refits = [], []
    chip_smoke._counting(tracker, "_run_model_update", mask_refits, lambda st, *a: st.frame_num)
    chip_smoke._counting(tracker, "_clf_refit", clf_refits, lambda: tracker.state.frame_num)
    init = tracker.initialize(seq[0][0], {"init_bbox": chip_smoke.vos_box(seq[0][1] == 1)})
    coarse, refined = (x.float().cpu() for x in sta_out[0])
    print(f"rts: STA's coarse logits (min, max) ({coarse.min():.4f}, {coarse.max():.4f}), "
          f"refined ({refined.min():.4f}, {refined.max():.4f}) over the "
          f"{tuple(refined.shape[-2:])} crop", flush=True)
    outs = [tracker.track(im) for im, _ in seq[1:]]
    return init, outs, mask_refits, clf_refits


def scores(args):
    seq = _sequence(chip_smoke.LWL_FRAMES)
    spec = chip_smoke.vos_spec("lwl_ytvos")
    tracker = LWLTracker(spec.params, spec.net, device="cuda")
    m0 = (seq[0][1] == 1).astype(np.float32)
    outs = [tracker.initialize(seq[0][0], {"init_bbox": chip_smoke.vos_box(m0),
                                           "init_mask": m0})]
    outs += [tracker.track(im) for im, _ in seq[1:]]
    areas = [int(o["segmentation"].sum()) for o in outs[1:]]
    ious = [float(((o["segmentation"] > 0) & (lab == 1)).sum() /
                  max(((o["segmentation"] > 0) | (lab == 1)).sum(), 1))
            for o, (_, lab) in zip(outs[1:], seq[1:])]
    mass = [float(o["segmentation_raw"].sum()) for o in outs[:-1]]
    print(f"lwl: mask areas (min, median, max) ({min(areas)}, {int(np.median(areas))}, "
          f"{max(areas)}) px of {chip_smoke.VOS_H * chip_smoke.VOS_W}; IoU with the ground truth "
          f"({min(ious):.3f}, {np.median(ious):.3f}, {max(ious):.3f}); previous-frame mass "
          f"below min_mask_area on {sum(m < spec.params.min_mask_area for m in mass)} frames; "
          f"areas of frames 1-12 {areas[:12]}", flush=True)
    del tracker, spec

    spec = chip_smoke.vos_spec("rts50")
    init, outs, mask_refits, clf_refits = _rts_run(spec, seq, -float("inf"), -float("inf"))
    peaks = np.asarray([o["clf_max_score"] for o in outs])
    print(f"rts never lost: STA's first mask {int(init['segmentation'].sum())} px; classifier "
          f"peaks (min, median, max) ({peaks.min():.5f}, {np.median(peaks):.5f}, "
          f"{peaks.max():.5f}); per frame {[round(x, 5) for x in peaks.tolist()]}; mask "
          f"refits {mask_refits}, classifier refits {clf_refits}", flush=True)
    settings = [(chip_smoke.RTS_NOT_FOUND_THRESHOLD, chip_smoke.RTS_TOO_SMALL_THRESHOLD)]
    if "auto" in args:
        for q in (0.1, 0.2, 0.35, 0.5):
            nf = round(float(np.quantile(peaks, q)), 5)
            settings += [(nf, nf), (nf, round(float(np.quantile(peaks, min(q + 0.25, 0.9))), 5))]
    settings += [tuple(float(x) for x in a.split(":")) for a in args if a != "auto"]
    for nf, too_small in dict.fromkeys(settings):
        _, outs, mask_refits, clf_refits = _rts_run(spec, seq, nf, too_small)
        lost = [o["lost_counter"] for o in outs]
        peaks = [round(o["clf_max_score"], 5) for o in outs]
        refound = [i + 1 for i in range(1, len(lost)) if lost[i - 1] > 0 and lost[i] == 0]
        margin = min(abs(o["clf_max_score"] - c) for o in outs for c in (nf, too_small))
        print(f"rts at {nf}:{too_small} (nearest peak {margin:.1e} from a cut): found "
              f"{lost.count(0)}, lost "
              f"{len(lost) - lost.count(0)}, re-found at {refound}; lost counter per frame "
              f"{''.join(str(min(c, 9)) for c in lost)}; mask refits {mask_refits}, classifier "
              f"refits {clf_refits}; peaks {peaks}", flush=True)


def stages(args):
    which = args[0] if args and args[0] in ("lwl", "multi", "rts") else "lwl"
    args = args[1:] if args and args[0] in ("lwl", "multi", "rts") else args
    n = int(args[0]) if args else 5
    n_frames = {"lwl": chip_smoke.LWL_FRAMES, "multi": chip_smoke.LWL_MULTI_FRAMES,
                "rts": chip_smoke.RTS_FRAMES}[which]
    seq = _sequence(n_frames + n)
    if which == "lwl":
        spec = chip_smoke.vos_spec("lwl_ytvos")
        tracker = LWLTracker(spec.params, spec.net, device="cuda")
        m0 = (seq[0][1] == 1).astype(np.float32)
        tracker.initialize(seq[0][0], {"init_bbox": chip_smoke.vos_box(m0), "init_mask": m0})
    elif which == "multi":
        spec = chip_smoke.vos_spec("lwl_ytvos")
        tracker = LWLMultiObjectTracker(spec.params, spec.net, device="cuda")
        tracker.initialize(seq[0][0], {"init_mask": seq[0][1], "object_ids": ["1", "2"]})
    else:
        spec = chip_smoke.vos_spec("rts50")
        tracker = RTSTracker(spec.params, spec.net, device="cuda", **spec.tracker_kwargs)
        tracker.initialize(seq[0][0], {"init_bbox": chip_smoke.vos_box(seq[0][1] == 1)})
    impl = tracker._impl if which == "multi" else tracker
    net = impl.net
    table = {"backbone to layer4": (net, "extract_backbone"),
             "target-model features": (net, "extract_target_model_features"),
             "label encoding of the memory": (net, "label_encode"),
             "filter update": (net, "tm_update_filter"),
             "decoder": (net.decoder, "forward"),
             "paste": (impl, "_paste"),
             "_seg_to_state": (impl, "_seg_to_state"),
             "memory update": (impl, "_update_memory"),
             "readback": (impl, "_readback")}
    if which == "rts":
        table.update({"classifier features and scores": (net, "extract_classification_feat"),
                      "classifier score encoding": (net.clf_encoder, "forward"),
                      "classifier memory": (tracker, "_clf_update_memory"),
                      "classifier refit": (tracker, "_clf_refit")})
    profile_stages(tracker, table, [im for im, _ in seq[1:n_frames + 1]],
                   [im for im, _ in seq[n_frames + 1:]], which)


def main():
    if not torch.cuda.is_available():
        print("lwl_check: needs a CUDA card", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else "scores"
    {"scores": scores, "stages": stages}[mode](sys.argv[2:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
