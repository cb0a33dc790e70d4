"""Per-module learning rates and step schedules (counterpart of
pytracking_tpu/training/optim.py, which builds them with optax).

The recipes give each module its own learning rate, and a module listed in
no group is either trained at the base rate or, with freeze_unlisted,
frozen. Here that is `torch.optim.Adam` (or `AdamW`) with one parameter
group per listed module prefix, and a `LambdaLR` stepped once per
optimiser step: the decay falls at multiples of step_size * steps_per_epoch
steps (staircase, as optax.exponential_decay(staircase=True)), or at the
milestones' epochs. Adam's defaults are optax's (0.9, 0.999, eps 1e-8).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch


def _step_decay(steps_per_epoch: int, step_size: int, gamma: float) -> Callable[[int], float]:
    every = step_size * max(steps_per_epoch, 1)
    return lambda step: gamma ** (step // every)


def _multi_step_decay(steps_per_epoch: int, milestones: Sequence[int],
                      gamma: float) -> Callable[[int], float]:
    bounds = [m * max(steps_per_epoch, 1) for m in milestones]
    return lambda step: gamma ** sum(step >= b for b in bounds)


def step_lr(base_lr: float, steps_per_epoch: int, step_size: int = 15,
            gamma: float = 0.2) -> Callable[[int], float]:
    """The learning rate at an optimiser step: torch's StepLR counted in
    epochs of steps_per_epoch steps."""
    decay = _step_decay(steps_per_epoch, step_size, gamma)
    return lambda step: base_lr * decay(step)


def multi_step_lr(base_lr: float, steps_per_epoch: int, milestones: Sequence[int],
                  gamma: float = 0.2) -> Callable[[int], float]:
    """The learning rate at an optimiser step: torch's MultiStepLR counted
    in epochs of steps_per_epoch steps."""
    decay = _multi_step_decay(steps_per_epoch, milestones, gamma)
    return lambda step: base_lr * decay(step)


def module_label(name: str, prefixes: Sequence[str]) -> Optional[str]:
    """The longest of `prefixes` that a parameter's dotted name falls under
    (None for none): a module path ('classifier.filter_optimizer', also
    written with '/' as flax paths are) or, for a prefix ending in '_', a
    raw prefix ('feature_extractor.layer3_' holds layer3_0, layer3_1, ...)."""
    for p in sorted(prefixes, key=len, reverse=True):
        q = p.replace("/", ".")
        if q.endswith("_") and name.startswith(q):
            return p
        if name == q or name.startswith(q + "."):
            return p
    return None


def adam_per_module(net: torch.nn.Module, base_lr: float, module_lrs: Dict[str, float],
                    steps_per_epoch: int, step_size: int = 15, gamma: float = 0.2,
                    milestones: Optional[Sequence[int]] = None,
                    weight_decay: Optional[float] = None, freeze_unlisted: bool = False):
    """(optimizer, scheduler): Adam (AdamW with weight_decay) over the
    net's parameters, a group per entry of module_lrs ({'classifier.
    filter_optimizer': 5e-4, 'feature_extractor': 2e-5, ...}) and the rest at
    base_lr, or with freeze_unlisted left out of the optimiser (never
    updated) and out of autograd (requires_grad off: the backward computes
    no gradient that nothing would read); every group decays on the same
    schedule."""
    groups: Dict[Optional[str], list] = {p: [] for p in module_lrs}
    groups[None] = []
    for name, param in net.named_parameters():
        groups[module_label(name, list(module_lrs))].append(param)
    param_groups = [{"params": groups[p], "lr": lr} for p, lr in module_lrs.items()
                    if groups[p]]
    if freeze_unlisted:
        for param in groups[None]:
            param.requires_grad_(False)
    elif groups[None]:
        param_groups.append({"params": groups[None], "lr": base_lr})
    if weight_decay is not None:
        optimizer = torch.optim.AdamW(param_groups, lr=base_lr, weight_decay=weight_decay)
    else:
        optimizer = torch.optim.Adam(param_groups, lr=base_lr)
    decay = _multi_step_decay(steps_per_epoch, milestones, gamma) if milestones is not None \
        else _step_decay(steps_per_epoch, step_size, gamma)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, decay)
