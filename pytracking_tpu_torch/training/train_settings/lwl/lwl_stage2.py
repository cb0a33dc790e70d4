"""LWL's stage-2 training recipe (counterpart of
pytracking_tpu/training/train_settings/lwl/lwl_stage2.py): stage 1's, with
the target model refined by 2 learner steps after each test frame but the
last, trained through those steps; checkpoints under lwl/lwl_stage2."""

from __future__ import annotations

from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.lwl import lwl_stage1
from pytracking_tpu_torch.training.train_settings.lwl.lwl_stage1 import (  # noqa: F401
    BASE_LR, FREEZE_UNLISTED, MILESTONES, MODULE_LRS, OUTPUT_SZ, make_net, make_sampler)

NUM_REFINEMENT_ITER = 2


def make_actor(settings: Settings, num_refinement_iter: int = NUM_REFINEMENT_ITER):
    """The recipe's actor, as a function of the net."""
    return lwl_stage1.make_actor(settings, num_refinement_iter)


def run(settings: Settings, **kwargs):
    settings.description = "LWL stage 2 (reference recipe defaults)"
    kwargs.setdefault("num_refinement_iter", NUM_REFINEMENT_ITER)
    return lwl_stage1.run(settings, **kwargs)
