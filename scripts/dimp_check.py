#!/usr/bin/env python3
"""Checks of a seeded DiMP-family tracker on chip_smoke.py's synthetic
sequence, on the card.

    python3 scripts/dimp_check.py scores [param] [threshold ...]
    python3 scripts/dimp_check.py gate [param] [frames]
    python3 scripts/dimp_check.py stages [param] [frames]

`param` is a parameter module of chip_smoke.DIMP_FAMILY (dimp50, super_dimp,
prdimp50, dimp18, super_dimp_simple; default dimp50), built with seed 0;
gate and stages run it at chip_smoke's not-found threshold for it.

scores: for each not-found threshold (the module's own first), `initialize`
+ the phase's frames (110 or 40) of `DiMPTracker`; prints the first and
second score peaks of the localisation (min / median / max over the
frames), the flag histogram and the optimiser iterations per frame. Random
weights put the peaks far below a trained net's; this shows which threshold
lets the seeded net find the target, so that the memory update and the
classifier refits run.

gate: chip_smoke.py's dimp_gate frame by frame (card against CPU, IEEE
float32, the card's draws replayed on the CPU): per frame the flags, the
box difference, and the refined boxes' top k + 1 final IoUs on both,
sorted.

stages: where a tracked frame's time goes, by stage of the step (backbone,
classification, localisation, box refinement, memory update, classifier
refit, the rest: crop and readback): host time, device kernel time and
kernel launches per frame under torch.profiler, the stages marked with
record_function, over a few frames after chip_smoke.py's 110.
"""

import collections
import copy
import dataclasses
import importlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from pytracking_tpu_torch.ops import dcf  # noqa: E402
from pytracking_tpu_torch.trackers import dimp as t_dimp  # noqa: E402


def _param_name(args):
    """(parameter module, the remaining arguments)."""
    if args and args[0] in chip_smoke.DIMP_FAMILY:
        return args[0], args[1:]
    return "dimp50", args


def scores(args):
    name, args = _param_name(args)
    spec = chip_smoke.dimp_spec(name)
    module = importlib.import_module(
        f"pytracking_tpu_torch.parameter.{chip_smoke.DIMP_FAMILY[name][1]}.{name}")
    thresholds = [module.params().target_not_found_threshold] + [float(x) for x in args]
    n_frames = chip_smoke.DIMP_FAMILY[name][3]
    peaks = []
    max2d = dcf.max2d

    def recording(a):
        value, idx = max2d(a)
        peaks.append(value)
        return value, idx

    t_dimp.dcf.max2d = recording
    bg = np.random.RandomState(0).randint(0, 90, (480, 640, 3)).astype(np.uint8)
    frames = [chip_smoke.dimp_frame(bg, t) for t in range(n_frames + 1)]
    for thr in thresholds:
        params = dataclasses.replace(spec.params, target_not_found_threshold=thr)
        tracker = t_dimp.DiMPTracker(params, spec.net, device="cuda")
        tracker.initialize(frames[0], chip_smoke.DIMP_INIT)
        peaks.clear()
        outs, iters = [], []
        for im in frames[1:]:
            out = tracker.track(im)
            outs.append(out)
            iters.append(tracker._classifier_iterations(t_dimp.FLAG_NAMES.index(out["flag"]),
                                                        tracker.state.frame_num))
        p = torch.stack(peaks).cpu().numpy().reshape(-1, 2)        # (frames, [max1, max2])
        stats = {name: (float(v.min()), float(np.median(v)), float(v.max()))
                 for name, v in (("max1", p[:, 0]), ("max2", p[:, 1]))}
        print(f"{name} threshold {thr}: peaks (min, median, max) "
              + ", ".join(f"{k} ({a:.4f}, {b:.4f}, {c:.4f})" for k, (a, b, c) in stats.items())
              + f"; flags {dict(collections.Counter(o['flag'] for o in outs))}; optimiser "
              f"iterations {dict(sorted(collections.Counter(iters).items()))}; last box "
              f"{[round(x, 1) for x in outs[-1]['target_bbox']]}", flush=True)


def gate(args):
    name, args = _param_name(args)
    n = int(args[0]) if args else chip_smoke.DIMP_GATE_FRAMES
    spec = chip_smoke.dimp_spec(name)
    params = spec.params
    net_cpu = copy.deepcopy(spec.net).to("cpu")
    trackers = {"card": t_dimp.DiMPTracker(params, spec.net, device="cuda"),
                "cpu": t_dimp.DiMPTracker(params, net_cpu, device="cpu")}
    draws, ious = [], {"card": [], "cpu": []}

    def recording(fn):
        def draw(*a):
            out = fn(*a)
            draws.append(out.cpu())
            return out
        return draw

    card, cpu = trackers["card"], trackers["cpu"]
    card._uniform, card._keep_mask = recording(card._uniform), recording(card._keep_mask)
    cpu._uniform = cpu._keep_mask = lambda *a: draws.pop(0)
    for name, tr in trackers.items():
        predict = tr.net.bb_regressor.predict_iou

        def recorded(*a, name=name, predict=predict):
            out = predict(*a)
            ious[name].append(out.detach())
            return out

        tr.net.bb_regressor.predict_iou = recorded
    bg = np.random.RandomState(0).randint(0, 90, (480, 640, 3)).astype(np.uint8)
    frames = [chip_smoke.dimp_frame(bg, t) for t in range(n + 1)]
    for tr in trackers.values():
        tr.initialize(frames[0], chip_smoke.DIMP_INIT)
    k = params.iounet_k
    for t, im in enumerate(frames[1:], 1):
        for v in ious.values():
            v.clear()
        out = {name: tr.track(im) for name, tr in trackers.items()}
        diff = np.abs(np.subtract(out["card"]["target_bbox"], out["cpu"]["target_bbox"])).max()
        line = f"frame {t}: flags {out['card']['flag']}/{out['cpu']['flag']}, box diff {diff:.3e} px"
        for name in trackers:
            final = torch.sort(ious[name][-1][0].cpu(), descending=True, stable=True)
            line += (f"; {name} top {final.indices[:k + 1].tolist()} iou "
                     f"{[round(x, 6) for x in final.values[:k + 1].tolist()]}")
        print(line, flush=True)


def profile_stages(tracker, stage_table, warm_frames, frames, label):
    """Host time, device kernel time and kernel launches per frame by stage
    under torch.profiler, over `frames` after `warm_frames` (the tracker is
    initialised). `stage_table`: label -> (object, attribute), each a method
    or function that the step calls through that attribute; its calls are
    marked with record_function. A kernel belongs to the stages whose host
    span holds its launch, on any thread (autograd runs the backward on its
    own thread); a kernel listed under its launch call and again under the
    op around it counts once, at the innermost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for stage, (obj, name) in stage_table.items():
        fn = getattr(obj, name)

        def marked(*a, fn=fn, stage=stage, **kw):
            with record_function(stage):
                return fn(*a, **kw)

        setattr(obj, name, marked)
    for im in warm_frames:
        tracker.track(im)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for im in frames:
            with record_function("frame"):
                tracker.track(im)
    n = len(frames)
    rows = collections.defaultdict(lambda: [0.0, 0, 0.0])     # host us, kernels, device us
    events = prof.events()
    spans = [e for e in events if (e.name in stage_table or e.name == "frame")
             and e.device_type == DeviceType.CPU]     # not their copies on the device timeline
    for e in spans:
        rows[e.name][0] += e.time_range.elapsed_us()
    for e in events:
        if not e.kernels or any(c.kernels for c in e.cpu_children):
            continue
        for span in spans:
            if span.time_range.start <= e.time_range.start <= span.time_range.end:
                rows[span.name][1] += len(e.kernels)
                rows[span.name][2] += sum(k.duration for k in e.kernels)
    fh, fk, fd = rows["frame"]
    print(f"{label} stages over {n} frames (per frame, under the profiler): host "
          f"{fh / n / 1e3:.3f} ms, "
          f"{fk / n:.0f} kernels, device {fd / n / 1e3:.3f} ms", flush=True)
    rest = [fh - sum(rows[x][0] for x in stage_table), fk - sum(rows[x][1] for x in stage_table),
            fd - sum(rows[x][2] for x in stage_table)]
    for stage, (h, k, d) in [(x, rows[x]) for x in stage_table] + \
            [("rest (crop, readback)", rest)]:
        print(f"  {stage:48s} host {h / n / 1e3:8.3f} ms ({100 * h / fh:4.1f}%)  "
              f"kernels {k / n:6.1f} ({100 * k / max(fk, 1):4.1f}%)  device {d / n / 1e3:7.3f} ms",
              flush=True)


def dimp_stage_table(tracker):
    """DiMP's stages: label -> (object, attribute)."""
    net = tracker.net
    return {"backbone": (net, "extract_backbone"),
            "classification feature": (net, "extract_classification_feat"),
            "classification scores": (net.classifier, "classify"),
            "localisation": (tracker, "_localize_streams"),
            "box refinement (IoU features, ascent steps)": (tracker, "_refine_streams"),
            "memory update": (tracker, "_update_memory_streams"),
            "classifier refit": (tracker, "_update_classifier")}


def stages(args):
    param, args = _param_name(args)
    n = int(args[0]) if args else 5
    spec = chip_smoke.dimp_spec(param)
    n_frames = chip_smoke.DIMP_FAMILY[param][3]
    tracker = t_dimp.DiMPTracker(spec.params, spec.net, device="cuda")
    bg = np.random.RandomState(0).randint(0, 90, (480, 640, 3)).astype(np.uint8)
    frames = [chip_smoke.dimp_frame(bg, t) for t in range(n_frames + n + 1)]
    tracker.initialize(frames[0], chip_smoke.DIMP_INIT)
    profile_stages(tracker, dimp_stage_table(tracker), frames[1:n_frames + 1],
                   frames[n_frames + 1:], param)


def main():
    if not torch.cuda.is_available():
        print("dimp_check: needs a CUDA card", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else "scores"
    {"scores": scores, "gate": gate, "stages": stages}[mode](sys.argv[2:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
