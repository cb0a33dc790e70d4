#!/usr/bin/env python3
"""Checks of the port's DiMP-50 training on the card (chip_smoke.py's
training phases).

    python3 scripts/train_check.py gate [runs] [sequences ...]
    python3 scripts/train_check.py train

gate: chip_smoke.py's `train_gate` figures (one train step of the seeded
DiMP-50 on the card and on the CPU from equal weights and one batch of the
recipe's pipeline of each given number of sequences) `runs` times (3) in
one process, nothing gated: the loss, the gradient leaves (the worst six),
the running statistics and Adam's step, card against CPU; then the card
against itself with the images changed by 3e-7 relative (how far float32
rounding alone moves them): to set the gate's bounds from.

train: chip_smoke.py's `train_dimp50` phase alone.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _report(tag, f):
    worst = sorted(f["grad"].items(), key=lambda kv: -kv[1])
    steps = sorted(f["step"].items(), key=lambda kv: -kv[1])
    bufs = sorted(f["buf"].items(), key=lambda kv: -kv[1])
    print(f"{tag}: loss {f['loss_value']:.6f} rel {f['loss']:.2e}, loss terms {f['stats']:.2e}, "
          f"accuracy {f['acc']}, running statistics {bufs[0][1]:.2e} ({bufs[0][0]}), "
          f"Adam's step {steps[0][1]:.2e} of lr ({steps[0][0]}), "
          f"{100 * f['step_share']:.4f}% of elements beyond {chip_smoke.TRAIN_STEP_GATE}",
          flush=True)
    for n, v in worst[:6]:
        print(f"{tag}:   grad {v:.2e} {n}", flush=True)
    print(f"{tag}:   grad median over {len(worst)} leaves "
          f"{sorted(f['grad'].values())[len(worst) // 2]:.2e}", flush=True)


def gate(args):
    """args: [runs] [sequences ...]: for each batch size, the card against
    the CPU `runs` times, and the card against itself with the images
    changed at rounding's scale."""
    runs = int(args[0]) if args else 3
    for n in [int(a) for a in args[1:]] or [chip_smoke.TRAIN_GATE_SEQUENCES]:
        batch = chip_smoke.train_gate_batch(sequences=n)
        for r in range(runs):
            _report(f"gate {n} sequences, run {r + 1}", chip_smoke.train_gate_figures(batch))
        _report(f"gate {n} sequences, card vs card at 3e-7",
                chip_smoke.train_gate_sensitivity(batch))


def train(args):
    chip_smoke.phase_train_dimp50()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("train_check: needs a CUDA card")
    chip_smoke.phase_device()
    mode = sys.argv[1] if len(sys.argv) > 1 else "gate"
    {"gate": gate, "train": train}[mode](sys.argv[2:])
