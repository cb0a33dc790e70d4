"""SuperDiMP's training recipe (counterpart of
pytracking_tpu/training/train_settings/dimp/super_dimp.py): PrDiMP-50's
objective and pipeline with DiMP-50's discriminative (Gauss-Newton) filter
optimiser, at the larger operating point: search area 6, 22x22 features,
352x352 crops, wider jitter."""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.dimp import prdimp50
from pytracking_tpu_torch.utils.device import resolve_device


def operating_point(settings: Settings) -> Settings:
    """SuperDiMP's crops and jitter, set on `settings` (returned)."""
    settings.search_area_factor = 6.0
    settings.feature_sz = 22
    settings.output_sz = settings.feature_sz * 16
    settings.center_jitter_factor = {"train": 3, "test": 5.5}
    settings.scale_jitter_factor = {"train": 0.25, "test": 0.5}
    return settings


def make_sampler(settings: Settings, *args, **kwargs):
    return prdimp50.make_sampler(operating_point(settings), *args, **kwargs)


def make_net(settings: Settings, device="cuda"):
    """The seeded DiMP-50 with the label sigma of the settings' operating
    point (0.25 / 6 x 22 = 0.917 cells at SuperDiMP's)."""
    output_sigma = settings.output_sigma_factor / settings.search_area_factor
    return dimpnet50(device=device, filter_size=settings.target_filter_sz, optim_iter=5,
                     optim_init_step=0.9, optim_init_reg=0.1,
                     init_gauss_sigma=output_sigma * settings.feature_sz, num_dist_bins=100,
                     bin_displacement=0.1, mask_init_factor=3.0, score_act="relu")


def run(settings: Settings, net=None, device="cuda", **kwargs):
    device = resolve_device(device)
    settings.description = "SuperDiMP (reference recipe defaults)"
    operating_point(settings)
    return prdimp50.run(settings, net=net if net is not None else make_net(settings, device),
                        device=device, **kwargs)
