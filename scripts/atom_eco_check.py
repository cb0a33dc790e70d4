#!/usr/bin/env python3
"""Checks of the seeded ATOM and ECO trackers (parameter/atom/*,
parameter/eco/*, seed 0) on chip_smoke.py's synthetic 480x640 sequence.

    python3 scripts/atom_eco_check.py launches [atom|eco|<module>] [cpu] [frames]
    python3 scripts/atom_eco_check.py stages [atom|eco] [frames]
    python3 scripts/atom_eco_check.py gate [runs]

launches: the operators the tracker dispatches per tracked frame (views
excluded), counted with a TorchDispatchMode over `frames` frames (5) after
10 warm-up frames: each one a kernel launch on the card. With `cpu` it runs
on the CPU at a 96x96 (ATOM) / 112x112 (ECO) crop at full width: the count
depends on the net and the step, not on the crop. Frames with a refit are
listed apart.

stages: where a tracked frame's time goes on the card, by stage of the step
(backbone; ATOM: projection, scores and their Fourier upsampling,
localisation, box refinement, memory, refit; ECO: Fourier samples,
scores (which hold the Fourier samples), memory, refit): host time, device
kernel time and kernel launches per frame under torch.profiler, over a few
frames after the ones chip_smoke.py's phase tracks.

gate: chip_smoke.py's `atom_gate` (card against CPU, each step from the
card's state) `runs` times (3) in one process, each with new trackers of
the same seeded net, its failed checks printed instead of raised: how far
the card's run-to-run variation moves each side's float32 refit from the
float64 one (the refit's bound) and the card-vs-CPU difference.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dimp_check import profile_stages  # noqa: E402
from pytracking_tpu_torch.trackers import atom as t_atom  # noqa: E402
from pytracking_tpu_torch.trackers.atom import ATOMTracker  # noqa: E402
from pytracking_tpu_torch.trackers.eco import ECOTracker  # noqa: E402

ATOM_MODULES = ("default", "default_vot", "atom_prob_ml", "atom_gmm_sampl",
                "multiscale_no_iounet")


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _tracker(name, device, reduced):
    """(tracker, label) of 'atom', 'eco' or a parameter module's name."""
    kind, module = ("atom", "default") if name == "atom" else ("eco", "default") \
        if name == "eco" else ("atom", name) if name in ATOM_MODULES else ("eco", name)
    spec = (chip_smoke.atom_spec if kind == "atom" else chip_smoke.eco_spec)(module, device)
    p = spec.params
    if reduced:
        p = dataclasses.replace(p, max_image_sample_size=96 ** 2, min_image_sample_size=96 ** 2)
    cls = ATOMTracker if kind == "atom" else ECOTracker
    return cls(p, spec.net, device=device), f"{kind} ({module})"


def _frames(n):
    bg = np.random.RandomState(0).randint(0, 90, (480, 640, 3)).astype(np.uint8)
    return [chip_smoke.dimp_frame(bg, t) for t in range(n + 1)]


def launches(args):
    name = args[0] if args else "atom"
    device = "cpu" if "cpu" in args[1:] else "cuda"
    n = int(next((a for a in args[1:] if a.isdigit()), 5))
    tracker, label = _tracker(name, device, device == "cpu")
    frames = _frames(10 + n)
    counter = _Count()
    with counter:
        tracker.initialize(frames[0], chip_smoke.DIMP_INIT)
    init = counter.n
    for im in frames[1:11]:
        tracker.track(im)
    plain, refit = [], []
    for im in frames[11:]:
        counter.n = 0
        with counter:
            tracker.track(im)
        fn = tracker.state.frame_num
        is_refit = fn % tracker.params.train_skipping == 1 if isinstance(tracker, ECOTracker) \
            else tracker._refit_iterations(t_atom.FLAG_NAMES.index("normal"), fn) > 0
        (refit if is_refit else plain).append((fn, counter.n))
    print(f"{label} on {device}: initialize {init} operators; per tracked frame "
          f"{[c for _, c in plain]} (frame_num {[f for f, _ in plain]}); refit frames "
          f"{refit}", flush=True)


def atom_stage_table(tracker):
    net = tracker.net
    return {"backbone (ResNet-18 to layer3)": (net, "extract_backbone"),
            "projection": (tracker, "_project"),
            "localisation": (tracker, "_localize"),
            "box refinement (IoU features, ascent steps)": (t_atom, "refine_target_box"),
            "memory update": (tracker, "_update_memory"),
            "refit (GN-CG)": (tracker, "_update_filter")}


def eco_stage_table(tracker):
    net = tracker.net
    return {"backbone (ResNet18-VGG-m1)": (net, "extract_backbone"),
            "Fourier samples (window, FFT, pad, interpolation)": (tracker, "_fourier_sample"),
            "scores (with the Fourier samples)": (tracker, "_score_maps"),
            "memory update": (tracker, "_update_memory"),
            "refit (GN-CG)": (tracker, "_update_filter")}


def stages(args):
    name = args[0] if args else "atom"
    n = int(args[1]) if len(args) > 1 else 10
    tracker, label = _tracker(name, "cuda", False)
    n_frames = chip_smoke.ATOM_FRAMES if name == "atom" else chip_smoke.ECO_FRAMES
    frames = _frames(n_frames + n)
    tracker.initialize(frames[0], chip_smoke.DIMP_INIT)
    table = (atom_stage_table if isinstance(tracker, ATOMTracker) else eco_stage_table)(tracker)
    profile_stages(tracker, table, frames[1:n_frames + 1], frames[n_frames + 1:], label)


def gate(args):
    runs = int(args[0]) if args else 3
    spec = chip_smoke.atom_spec("default")
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            print(f"gate: check failed: {msg}", flush=True)

    chip_smoke.check = check
    for r in range(runs):
        print(f"gate: run {r + 1} of {runs}", flush=True)
        chip_smoke.phase_atom_gate(spec, tag=f"atom_gate_{r + 1}")
    print(f"gate: {len(failed)} failed checks in {runs} runs", flush=True)


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "launches"
    if not torch.cuda.is_available() and not (mode == "launches" and "cpu" in sys.argv):
        print("atom_eco_check: needs a CUDA card (launches: or `cpu`)", file=sys.stderr)
        return 2
    {"launches": launches, "stages": stages, "gate": gate}[mode](sys.argv[2:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
