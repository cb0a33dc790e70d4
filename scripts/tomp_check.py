#!/usr/bin/env python3
"""Checks of the seeded ToMP and TaMOs-SwinBase trackers on chip_smoke.py's
synthetic sequences, on the card.

    python3 scripts/tomp_check.py scores [param] [threshold:conf[:distractor] ...]
    python3 scripts/tomp_check.py stages [param] [frames]

`param` is tomp50 (default) or tomp101, built with seed 0 in IEEE float32;
`stages` also takes tamos_swin_base (bf16, two objects, as chip_smoke.py's
tamos_swin phase runs it).

scores: for each setting of not-found threshold, memory confidence
(`conf_ths`) and distractor threshold (the module's own first, then
chip_smoke.py's, then the arguments; the distractor threshold defaults to
the module's 0.8), `initialize` + the phase's frames (110 for ToMP-50, 40
for ToMP-101) of `ToMPTracker`; prints the first and second score peaks of
the localisation (min / median / max over the frames), the flag histogram,
the frame on which slot 1 is first filled, the memory updates, and the
first peak and flag (n, N, H, U) of every frame. Random weights put the raw
peaks nowhere near a trained net's; this shows which setting lets the
seeded net store frames and lose the target, so that the memory update and
the search-area rescaling both run.

stages: where a tracked frame's time goes, by stage of the step: host time,
device kernel time and kernel launches per frame under torch.profiler, the
stages marked with record_function, over a few frames after the phase's.
"""

import collections
import dataclasses
import functools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from pytracking_tpu_torch.ops import dcf  # noqa: E402
from pytracking_tpu_torch.trackers import tomp as t_tomp  # noqa: E402


def _param_name(args, choices):
    """(parameter module, the remaining arguments)."""
    if args and args[0] in choices:
        return args[0], args[1:]
    return "tomp50", args


def scores(args):
    name, args = _param_name(args, chip_smoke.TOMP)
    spec = chip_smoke.tomp_spec(name)
    _, thr, conf, dist, n_frames, _ = chip_smoke.TOMP[name]
    settings = [(0.25, 0.9, 0.8), (thr, conf, dist)]
    for a in args:
        values = [float(x) for x in a.split(":")]
        settings.append(tuple(values) + (0.8,) * (3 - len(values)))
    peaks = []
    max2d = dcf.max2d

    def recording(a):
        value, idx = max2d(a)
        peaks.append(value)
        return value, idx

    t_tomp.dcf.max2d = recording
    bg = np.random.RandomState(0).randint(0, 90, (480, 640, 3)).astype(np.uint8)
    frames = [chip_smoke.dimp_frame(bg, t) for t in range(n_frames + 1)]
    for thr, conf, dist in settings:
        params = dataclasses.replace(spec.params, target_not_found_threshold=thr, conf_ths=conf,
                                     distractor_threshold=dist)
        tracker = t_tomp.ToMPTracker(params, spec.net, device="cuda")
        tracker.initialize(frames[0], chip_smoke.DIMP_INIT)
        peaks.clear()
        outs, weights = [], []
        for im in frames[1:]:
            outs.append(tracker.track(im))
            weights.append(tracker.state.mem_weights)
        p = torch.stack(peaks).cpu().numpy().reshape(-1, 2)        # (frames, [max1, max2])
        stats = {k: (float(v.min()), float(np.median(v)), float(v.max()))
                 for k, v in (("max1", p[:, 0]), ("max2", p[:, 1]))}
        fill = next((i + 1 for i, w in enumerate(weights) if float(w[1]) > 0), None)
        updates = sum(not torch.equal(a, b) for a, b in zip(weights[:-1], weights[1:]))
        letters = {"normal": "n", "not_found": "N", "hard_negative": "H", "uncertain": "U"}
        per_frame = " ".join(f"{float(x):.4f}{letters[o['flag']]}" for x, o in zip(p[:, 0], outs))
        print(f"{name} threshold {thr} conf {conf} distractor {dist}: peaks (min, median, max) "
              + ", ".join(f"{k} ({a:.4f}, {b:.4f}, {c:.4f})" for k, (a, b, c) in stats.items())
              + f"; flags {dict(collections.Counter(o['flag'] for o in outs))}; slot 1 first "
              f"filled on frame {fill}, updates after it {updates}; per frame: {per_frame}",
              flush=True)


# label: (object path from the tracker, method)
TOMP_STAGES = {
    "backbone": ("net", "extract_backbone"),
    "head feature": ("net.head", "extract_head_feat"),
    "filter predictor (transformer)": ("net", "head_get_filters_parallel"),
    "classifier": ("net", "head_classify"),
    "box regressor": ("net", "head_bbreg"),
    "localisation": ("", "_localize_streams"),
    "memory update": ("", "_update_memory_streams"),
}
TAMOS_STAGES = {
    "backbone": ("net", "extract_backbone"),
    "head feature": ("net", "extract_head_feat"),
    "filter predictor (transformer)": ("net", "predict_filters_parallel"),
    "FPN": ("net", "run_fpn"),
    "classifier": ("net", "classify_trafo"),
    "box regressor": ("net", "bbreg"),
    "localisation": ("", "_localize_streams"),
    "memory update": ("", "_update_memory_streams"),
}


def stages(args):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    name, args = _param_name(args, tuple(chip_smoke.TOMP) + ("tamos_swin_base",))
    n = int(args[0]) if args else 5
    bg = np.random.RandomState(0).randint(0, 90, (480, 640, 3)).astype(np.uint8)
    if name == "tamos_swin_base":
        from pytracking_tpu_torch.parameter.tamos import tamos_swin_base
        from pytracking_tpu_torch.trackers.tamos import TaMOsTracker

        spec = tamos_swin_base.parameters(device="cuda", dtype=torch.bfloat16, seed=0)
        tracker = TaMOsTracker(spec.params, spec.net, device="cuda")
        table, n_frames = TAMOS_STAGES, chip_smoke.N_FRAMES
        frames = [chip_smoke.synthetic_frame(bg, t) for t in range(n_frames + n + 1)]
        info = {"init_bbox": {"1": [200, 150, 60, 80], "2": [400, 260, 80, 60]},
                "init_object_ids": ["1", "2"], "object_ids": ["1", "2"]}
    else:
        spec = chip_smoke.tomp_spec(name)
        tracker = t_tomp.ToMPTracker(spec.params, spec.net, device="cuda")
        table, n_frames = TOMP_STAGES, chip_smoke.TOMP[name][4]
        frames = [chip_smoke.dimp_frame(bg, t) for t in range(n_frames + n + 1)]
        info = chip_smoke.DIMP_INIT
    for label, (path, method) in table.items():
        obj = functools.reduce(getattr, path.split("."), tracker) if path else tracker
        fn = getattr(obj, method)

        def marked(*a, fn=fn, label=label, **kw):
            with record_function(label):
                return fn(*a, **kw)

        setattr(obj, method, marked)
    tracker.initialize(frames[0], info)
    for im in frames[1:n_frames + 1]:
        tracker.track(im)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for im in frames[n_frames + 1:]:
            with record_function("frame"):
                tracker.track(im)
    # a kernel belongs to the stages whose host span holds its launch; a
    # kernel listed under its launch call and again under the op around it
    # counts once, at the innermost
    rows = collections.defaultdict(lambda: [0.0, 0, 0.0])     # host us, kernels, device us
    events = prof.events()
    spans = [e for e in events if (e.name in table or e.name == "frame")
             and e.device_type == DeviceType.CPU]
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
    print(f"{name} stages over {n} frames (per frame, under the profiler): host "
          f"{fh / n / 1e3:.3f} ms, {fk / n:.0f} kernels, device {fd / n / 1e3:.3f} ms",
          flush=True)
    rest = [fh - sum(rows[x][0] for x in table), fk - sum(rows[x][1] for x in table),
            fd - sum(rows[x][2] for x in table)]
    for label, (h, k, d) in [(x, rows[x]) for x in table] + [("rest (crop, readback)", rest)]:
        print(f"  {label:34s} host {h / n / 1e3:8.3f} ms ({100 * h / fh:4.1f}%)  "
              f"kernels {k / n:6.1f} ({100 * k / max(fk, 1):4.1f}%)  device {d / n / 1e3:7.3f} ms",
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("tomp_check: needs a CUDA card", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else "scores"
    {"scores": scores, "stages": stages}[mode](sys.argv[2:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
