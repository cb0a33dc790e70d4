#!/usr/bin/env python3
"""Checks of the batched DiMP-family server (pytracking_tpu_torch/parallel/
serving.py) on chip_smoke.py's synthetic streams (seed-0 weights).

    python3 scripts/serving_check.py launches [dimp50|super_dimp|...] [cpu] [B ...]

launches: the operators one server step dispatches (views excluded),
counted with a TorchDispatchMode over 3 steps after 3 warm-up steps, for
each B (default 1, 8, 32), beside the single-stream tracker's per frame and
the deferred update's (the tick): on the card each operator is a kernel
launch. With `cpu` it runs on the CPU at a 96x96 crop and full width: the
count depends on the net, the step and B, not on the crop.
"""

import dataclasses
import os
import sys

import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from pytracking_tpu_torch.parallel.serving import BatchedTrackerServer  # noqa: E402
from pytracking_tpu_torch.trackers.dimp import DiMPTracker  # noqa: E402


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _count(fn):
    counter = _Count()
    with counter:
        fn()
    return counter.n


def launches(args):
    name = next((a for a in args if a in chip_smoke.DIMP_FAMILY), "dimp50")
    device = "cpu" if "cpu" in args else "cuda"
    streams = [int(a) for a in args if a.isdigit()] or [1, 8, 32]
    spec = chip_smoke.dimp_spec(name, device)
    p = spec.params
    if device == "cpu":
        p = dataclasses.replace(p, image_sample_size=96)
    bg = np.random.RandomState(0).randint(0, 90, (480, 640, 3)).astype(np.uint8)
    single = DiMPTracker(p, spec.net, device=device)
    single.initialize(chip_smoke.stream_frame(bg, 0, 0), {"init_bbox": chip_smoke.stream_box(0)})
    for t in range(1, 4):
        single.track(chip_smoke.stream_frame(bg, 0, t))
    per_frame = [_count(lambda t=t: single.track(chip_smoke.stream_frame(bg, 0, t)))
                 for t in range(4, 7)]
    print(f"{name} on {device} (sample {p.image_sample_size}): single-stream tracker "
          f"{per_frame} operators per frame", flush=True)
    for B in streams:
        server = BatchedTrackerServer(DiMPTracker, p, spec.net, device=device, bf16=False)
        server.initialize([chip_smoke.stream_frame(bg, b, 0) for b in range(B)],
                          [chip_smoke.stream_box(b) for b in range(B)])
        for t in range(1, 4):
            server.track(chip_smoke.stream_batch(bg, B, t))
        steps = [_count(lambda t=t: server.track(chip_smoke.stream_batch(bg, B, t)))
                 for t in range(4, 7)]
        tick = _count(lambda: setattr(server, "states", server.tracker._serve_tick(server.states)))
        print(f"{name} on {device}: B={B}: {steps} operators per step, the deferred "
              f"update {tick}", flush=True)


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "launches"
    if mode != "launches":
        print(__doc__, file=sys.stderr)
        return 2
    if "cpu" not in sys.argv:
        import torch

        if not torch.cuda.is_available():
            print("serving_check: needs a CUDA card (or `cpu`)", file=sys.stderr)
            return 2
    launches(sys.argv[2:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
