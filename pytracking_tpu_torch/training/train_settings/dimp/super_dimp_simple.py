"""SuperDiMP-simple's training recipe (counterpart of
pytracking_tpu/training/train_settings/dimp/super_dimp_simple.py):
SuperDiMP's operating point and objective with the generic Gauss-Newton
steepest descent over DiMP's learned residual (dimpnet50_simple)."""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50_simple
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.dimp import prdimp50, super_dimp
from pytracking_tpu_torch.utils.device import resolve_device

make_sampler = super_dimp.make_sampler


def make_net(settings: Settings, device="cuda"):
    output_sigma = settings.output_sigma_factor / settings.search_area_factor
    return dimpnet50_simple(device=device, filter_size=settings.target_filter_sz, optim_iter=5,
                            init_gauss_sigma=output_sigma * settings.feature_sz)


def run(settings: Settings, net=None, device="cuda", **kwargs):
    device = resolve_device(device)
    settings.description = "SuperDiMP-simple (reference recipe defaults)"
    super_dimp.operating_point(settings)
    return prdimp50.run(settings, net=net if net is not None else make_net(settings, device),
                        device=device, **kwargs)
