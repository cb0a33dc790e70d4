#!/usr/bin/env python3
"""Checks of the port's training on the card (chip_smoke.py's training
phases), per recipe.

    python3 scripts/train_check.py gate [module name] [runs] [sequences ...]
    python3 scripts/train_check.py train [module name]
    python3 scripts/train_check.py dropout
    python3 scripts/train_check.py rtslabel [runs]
    python3 scripts/train_check.py rtsstages

Several commands run in one process when joined by '+', e.g.
`gate tomp tomp50 1 + train tamos tamos_resnet50 + dropout`.

The recipe is named as `run_training` names it (train_settings/<module>/
<name>.py; dimp dimp50 by default).

gate: chip_smoke.py's `train_gate` figures for the recipe (dimp dimp50:
`train_gate`; dimp prdimp50: `train_prdimp_gate`; bbreg atom:
`train_atom_gate`; tomp tomp50: `train_tomp_gate`; tamos tamos_resnet50:
`train_tamos_gate`; lwl lwl_stage2: `train_lwl_gate`; rts rts50:
`train_rts_gate`; kys kys: `train_kys_gate`, with the score jitter off and
on; keep_track keep_track: `train_keep_track_gate`; any recipe with
`make_actor`): one train step of the
recipe's seeded net on the card and on the CPU from equal weights and one
batch of the recipe's pipeline of each given number of sequences, `runs`
times (3) in one process, nothing gated: the loss, the gradient leaves (the
worst six), the running statistics and Adam's step, card against CPU; then
the card against itself with the images changed by 3e-7 relative (how far
float32 rounding alone moves them): to set the gate's bounds from. Each
run also prints its seconds and the card's peak memory over it.

train: chip_smoke.py's training phase of the recipe alone (dimp dimp50:
`train_dimp50`; dimp prdimp50: `train_prdimp50`; bbreg atom: `train_atom`;
tomp tomp50: `train_tomp50`; tamos tamos_resnet50: `train_tamos`; lwl
lwl_stage2: `train_lwl`; rts rts50: `train_rts`; kys kys: `train_kys`;
keep_track keep_track: `train_keep_track`; any other recipe: one
epoch of chip_smoke.TRAIN_SAMPLES sequences with `train_prdimp50`'s checks
and figures, ToMP's, TaMOs's and LWL's with theirs).

dropout: chip_smoke.py's `train_dropout`.

rtslabel: RTS-50's gate figures twice, `runs` times (3) each with the card
against itself at 3e-7 after them: with the fallback train labels each side
computes itself, then with the same labels computed once on the CPU
(with_rts_train_label); each loss term apart.

rtsstages: RTS-50's classifier branch on the gate batch, card against CPU
stage by stage (chip_smoke.rts_classifier_figures: layer3, the
classification features, the fitted filter and the test scores, and the
card's fit from the CPU's features); then the gate's figures with cuDNN off
on the card, against the CPU and against itself at 3e-7.
"""

import os
import sys
import time

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
    print(f"{tag}:   loss terms " + ", ".join(f"{k} {v:.2e}" for k, v in f["terms"].items()),
          flush=True)
    for n, v in worst[:6]:
        print(f"{tag}:   grad {v:.2e} {n}", flush=True)
    print(f"{tag}:   grad median over {len(worst)} leaves "
          f"{sorted(f['grad'].values())[len(worst) // 2]:.2e}", flush=True)


PHASES = {("dimp", "dimp50"): chip_smoke.phase_train_dimp50,
          ("dimp", "prdimp50"): chip_smoke.phase_train_prdimp50,
          ("bbreg", "atom"): chip_smoke.phase_train_atom,
          ("tomp", "tomp50"): chip_smoke.phase_train_tomp50,
          ("tamos", "tamos_resnet50"): chip_smoke.phase_train_tamos,
          ("lwl", "lwl_stage2"): chip_smoke.phase_train_lwl,
          ("rts", "rts50"): chip_smoke.phase_train_rts,
          ("kys", "kys"): chip_smoke.phase_train_kys,
          ("keep_track", "keep_track"): chip_smoke.phase_train_keep_track}


def _recipe_arg(args):
    """((module, name), the remaining args): two leading arguments that are
    not numbers name the recipe."""
    if len(args) >= 2 and not args[0].isdigit():
        return (args[0], args[1]), args[2:]
    return ("dimp", "dimp50"), args


def gate(args):
    """args: [module name] [runs] [sequences ...]: for each batch size, the card
    against the CPU `runs` times, and the card against itself with the
    images changed at rounding's scale."""
    recipe, args = _recipe_arg(args)
    name = recipe[1]
    runs = int(args[0]) if args else 3
    variants = {"": None} if recipe != ("kys", "kys") else \
        {" jitter off": {"jitter": False}, " jitter on": chip_smoke.KYS_GATE_JITTER}
    for n in [int(a) for a in args[1:]] or [chip_smoke.TRAIN_GATE_SEQUENCES]:
        batch = chip_smoke.train_gate_batch(sequences=n, recipe=recipe)
        for label, kw in variants.items():
            for r in range(runs):
                _timed(f"gate {name}{label} {n} sequences, run {r + 1}",
                       lambda: chip_smoke.train_gate_figures(batch, recipe, kw))
            _timed(f"gate {name}{label} {n} sequences, card vs card at 3e-7",
                   lambda: chip_smoke.train_gate_sensitivity(batch, recipe=recipe,
                                                             actor_kwargs=kw))


def _timed(tag, figures):
    """_report of figures(), with its seconds and the card's peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = figures()
    print(f"{tag}: {time.perf_counter() - t0:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    _report(tag, f)


def train(args):
    recipe, _ = _recipe_arg(args)
    if recipe in PHASES:
        PHASES[recipe]()
        return
    tag = f"train_{recipe[1]}"
    if recipe[0] in ("tomp", "tamos"):
        chip_smoke._train_transformer_phase(tag, *recipe)
        return
    if recipe[0] == "lwl":
        chip_smoke._train_vos_phase(tag, *recipe)
        return
    trainer, _, peak, _, seeded = chip_smoke._train_recipe_run(tag, *recipe,
                                                               chip_smoke.TRAIN_SAMPLES)
    chip_smoke._moved_parameters(tag, trainer, *recipe, seeded=seeded)
    chip_smoke._step_report(tag, (trainer,), peak)
    chip_smoke._profile_train_step(tag, trainer)


def dropout(args):
    chip_smoke.phase_train_dropout()


def rtsstages(args):
    recipe = ("rts", "rts50")
    batch = chip_smoke.train_gate_batch(recipe=recipe)
    for k, v in chip_smoke.rts_classifier_figures(batch).items():
        print(f"rtsstages: card vs CPU {k}: {v:.2e}", flush=True)
    step = chip_smoke._train_gate_step

    def no_cudnn(device, *a, **k):
        if device != "cuda":
            return step(device, *a, **k)
        with torch.backends.cudnn.flags(enabled=False):
            return step(device, *a, **k)

    chip_smoke._train_gate_step = no_cudnn
    try:
        _timed("rtsstages: cuDNN off on the card",
               lambda: chip_smoke.train_gate_figures(batch, recipe))
        _timed("rtsstages: cuDNN off on the card, card vs card at 3e-7",
               lambda: chip_smoke.train_gate_sensitivity(batch, recipe=recipe))
    finally:
        chip_smoke._train_gate_step = step


def with_rts_train_label(batch):
    """An RTS gate batch with the classifier's fallback train labels
    computed once on the CPU (rts_net.fallback_train_label on the stride-32
    grid) as 'clf_train_label', so that the card and the CPU fit the
    classifier to the same labels."""
    from pytracking_tpu_torch.models.rts.rts_net import fallback_train_label

    rts = chip_smoke._recipe("rts", "rts50")
    H, W = batch["train_images"].shape[2:4]
    label = fallback_train_label(torch.from_numpy(batch["train_anno"]),
                                 (H // rts.CLF_STRIDE, W // rts.CLF_STRIDE), (H, W), 4)
    return {**batch, "clf_train_label": label.numpy()}


def rtslabel(args):
    runs = int(args[0]) if args else 3
    recipe = ("rts", "rts50")
    fallback = chip_smoke.train_gate_batch(recipe=recipe)
    for kind, batch in (("fallback", fallback),
                        ("explicit", with_rts_train_label(fallback))):
        for r in range(runs):
            _timed(f"rtslabel {kind} labels, run {r + 1}",
                   lambda: chip_smoke.train_gate_figures(batch, recipe))
        _timed(f"rtslabel {kind} labels, card vs card at 3e-7",
               lambda: chip_smoke.train_gate_sensitivity(batch, recipe=recipe))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("train_check: needs a CUDA card")
    chip_smoke.phase_device()
    commands, cmd = [], []
    for a in sys.argv[1:] + ["+"]:
        if a == "+":
            commands.append(cmd or ["gate"])
            cmd = []
        else:
            cmd.append(a)
    for mode, *args in commands:
        {"gate": gate, "train": train, "dropout": dropout, "rtslabel": rtslabel,
         "rtsstages": rtsstages}[mode](args)
