"""LWL's box-init training recipe (counterpart of
pytracking_tpu/training/train_settings/lwl/lwl_boxinit.py): one train and
one test frame per sequence (the train frames alone are used), LWL's
pipeline at 352x352, masks decoded from the train frames' encoded boxes
with the Lovász hinge on their masks, and Adam on the box label encoder
alone (1e-3), everything else frozen, decayed by 0.2 every 20 epochs. It
trains on the procedural SyntheticVOSVideoDataset unless `datasets` are
given; `net` replaces the seeded box-init LWL.
"""

from __future__ import annotations

from pytracking_tpu_torch.models.lwl.lwl_net import steepest_descent_resnet50_boxinit
from pytracking_tpu_torch.training.actors.tracking import LWLBoxActor
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.lwl import lwl_stage1
from pytracking_tpu_torch.training.train_settings.lwl.lwl_stage1 import OUTPUT_SZ
from pytracking_tpu_torch.training.trainer import train_recipe
from pytracking_tpu_torch.utils.device import resolve_device

# Adam's learning rate per module; the rest of the net is frozen
BASE_LR = 2e-4
MODULE_LRS = {"box_label_encoder": 1e-3}
FREEZE_UNLISTED = True
STEP_SIZE = 20


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000,
                 seed=None, output_sz: int = OUTPUT_SZ):
    """LWL's sampler with one test frame."""
    return lwl_stage1.make_sampler(settings, datasets, samples_per_epoch, seed, output_sz,
                                   num_test_frames=1)


def make_net(settings: Settings, device="cuda"):
    """The seeded box-init LWL."""
    return steepest_descent_resnet50_boxinit(device=device)


def make_actor(settings: Settings):
    """The recipe's actor, as a function of the net."""
    return LWLBoxActor


def run(settings: Settings, datasets=None, max_epochs: int = 40,
        samples_per_epoch: int = 2000, net=None, device="cuda", output_sz: int = OUTPUT_SZ):
    """Sets settings.output_sz to `output_sz`, as the JAX recipe does."""
    device = resolve_device(device)
    settings.description = getattr(settings, "description", None) or \
        "LWL boxinit (reference recipe defaults)"
    settings.output_sz = output_sz
    sampler = make_sampler(settings, datasets, samples_per_epoch, output_sz=output_sz)
    net = net if net is not None else make_net(settings, device)
    return train_recipe(settings, sampler, net, make_actor(settings), BASE_LR, MODULE_LRS,
                        max_epochs, device, freeze_unlisted=FREEZE_UNLISTED,
                        step_size=STEP_SIZE)
