"""DiMP-18's training recipe (counterpart of
pytracking_tpu/training/train_settings/dimp/dimp18.py): DiMP-50's recipe
with the ResNet-18 net."""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet18
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.dimp import dimp50
from pytracking_tpu_torch.utils.device import resolve_device

make_sampler = dimp50.make_sampler


def make_net(settings: Settings, device="cuda"):
    output_sigma = settings.output_sigma_factor / settings.search_area_factor
    return dimpnet18(device=device, filter_size=settings.target_filter_sz, optim_iter=5,
                     init_gauss_sigma=output_sigma * settings.feature_sz, num_dist_bins=100,
                     bin_displacement=0.1, mask_init_factor=3.0)


def run(settings: Settings, net=None, device="cuda", **kwargs):
    device = resolve_device(device)
    settings.description = "DiMP-18 (reference recipe defaults)"
    return dimp50.run(settings, net=net if net is not None else make_net(settings, device),
                      device=device, **kwargs)
