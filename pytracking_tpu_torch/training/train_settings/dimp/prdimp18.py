"""PrDiMP-18's training recipe (counterpart of
pytracking_tpu/training/train_settings/dimp/prdimp18.py): PrDiMP-50's
recipe with the ResNet-18 KL/Newton net."""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.dimpnet import klcedimpnet18
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.dimp import prdimp50
from pytracking_tpu_torch.utils.device import resolve_device

make_sampler = prdimp50.make_sampler


def make_net(settings: Settings, device="cuda"):
    output_sigma = settings.output_sigma_factor / settings.search_area_factor
    return klcedimpnet18(device=device, filter_size=settings.target_filter_sz,
                         gauss_sigma=output_sigma * settings.feature_sz)


def run(settings: Settings, net=None, device="cuda", **kwargs):
    device = resolve_device(device)
    settings.description = "PrDiMP-18 (reference recipe defaults)"
    return prdimp50.run(settings, net=net if net is not None else make_net(settings, device),
                        device=device, **kwargs)
