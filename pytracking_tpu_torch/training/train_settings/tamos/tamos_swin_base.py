"""TaMOs-SwinBase's training recipe (counterpart of
pytracking_tpu/training/train_settings/tamos/tamos_swin_base.py):
TaMOs-ResNet50's recipe with the Swin-Base net. No learning-rate prefix
names a Swin parameter ('feature_extractor.layer3_' is ResNet's), so the
whole backbone stays frozen, as in the JAX recipe."""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.tamosnet import tamosnet_swin_base
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.tamos import tamos_resnet50
from pytracking_tpu_torch.training.train_settings.tamos.tamos_resnet50 import (  # noqa: F401
    BASE_LR, FREEZE_UNLISTED, MILESTONES, MODULE_LRS, NUM_OBJECTS, OUTPUT_SZ, WEIGHT_DECAY,
    make_actor, make_sampler)
from pytracking_tpu_torch.utils.device import resolve_device


def make_net(settings: Settings, device="cuda", num_objects: int = NUM_OBJECTS):
    """The seeded TaMOs-SwinBase at the settings' feature_sz."""
    return tamosnet_swin_base(num_tokens=num_objects, feature_sz=settings.feature_sz,
                              device=device)


def run(settings: Settings, net=None, device="cuda", num_objects: int = NUM_OBJECTS,
        output_sz: int = OUTPUT_SZ, **kwargs):
    device = resolve_device(device)
    settings.description = "TaMOs-SwinBase (reference recipe defaults)"
    if net is None:
        settings.feature_sz = output_sz // 16
        net = make_net(settings, device, num_objects)
    return tamos_resnet50.run(settings, net=net, device=device, num_objects=num_objects,
                              output_sz=output_sz, **kwargs)
