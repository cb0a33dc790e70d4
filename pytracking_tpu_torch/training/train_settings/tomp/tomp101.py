"""ToMP-101's training recipe (counterpart of
pytracking_tpu/training/train_settings/tomp/tomp101.py): ToMP-50's recipe
with the ResNet-101 net."""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.tompnet import tompnet101
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.tomp import tomp50
from pytracking_tpu_torch.training.train_settings.tomp.tomp50 import (  # noqa: F401
    BASE_LR, FREEZE_UNLISTED, MILESTONES, MODULE_LRS, WEIGHT_DECAY, make_actor, make_sampler)
from pytracking_tpu_torch.utils.device import resolve_device


def make_net(settings: Settings, device="cuda"):
    """The seeded ToMP-101 with its backbone's BatchNorms frozen."""
    return tompnet101(feature_sz=settings.feature_sz, freeze_backbone_bn=True, device=device)


def run(settings: Settings, net=None, device="cuda", **kwargs):
    device = resolve_device(device)
    settings.description = "ToMP-101 (reference recipe defaults)"
    return tomp50.run(settings, net=net if net is not None else make_net(settings, device),
                      device=device, **kwargs)
