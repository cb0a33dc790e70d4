"""PrDiMP-50's training recipe (counterpart of
pytracking_tpu/training/train_settings/dimp/prdimp50.py): DiMP-50's frames
and crops (3 train and 3 test frames per sequence, 288x288 at search area
5), 128 IoU-Net proposals per test frame drawn from a two-component
Gaussian mixture with their densities, label densities on the score grid,
the KL objective on the net's IoU scores and on every iterate of the
Newton filter optimiser, and Adam with per-module learning rates decayed by
0.2 every 15 epochs. It trains on the procedural SyntheticVideoDataset
unless `datasets` are given; `net` replaces the seeded PrDiMP-50.
"""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.dimpnet import klcedimpnet50
from pytracking_tpu_torch.training import transforms as tfm
from pytracking_tpu_torch.training.actors.tracking import KLDiMPActor
from pytracking_tpu_torch.training.datasets.synthetic_video import SyntheticVideoDataset
from pytracking_tpu_torch.training.processing import KLDiMPProcessing
from pytracking_tpu_torch.training.sampler import DiMPSampler
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.trainer import train_recipe
from pytracking_tpu_torch.utils.device import resolve_device


# Adam's learning rate per module; the rest of the net trains at BASE_LR
BASE_LR = 2e-4
MODULE_LRS = {"classifier": 1e-3, "bb_regressor": 1e-3, "feature_extractor": 2e-5}
FREEZE_UNLISTED = False              # every module trains


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000,
                 seed=None) -> DiMPSampler:
    """The recipe's sampler and processing (seed: its generators' seed, None
    for the OS's entropy)."""
    datasets = datasets or [SyntheticVideoDataset(num_sequences=256, seq_len=40)]
    transform_joint = tfm.Transform(tfm.ToGrayscale(probability=0.05))
    transform_train = tfm.Transform(tfm.BrightnessJitter(0.2), tfm.RandomHorizontalFlip(0.5))

    output_sigma = settings.output_sigma_factor / settings.search_area_factor
    proposal_params = {"boxes_per_frame": 128, "proposal_sigma": [(0.05, 0.05), (0.5, 0.5)]}
    label_params = {"feature_sz": settings.feature_sz, "sigma_factor": output_sigma,
                    "kernel_sz": settings.target_filter_sz}
    processing = KLDiMPProcessing(search_area_factor=settings.search_area_factor,
                                  output_sz=settings.output_sz,
                                  center_jitter_factor=settings.center_jitter_factor,
                                  scale_jitter_factor=settings.scale_jitter_factor,
                                  proposal_params=proposal_params,
                                  label_function_params=label_params,
                                  train_transform=transform_train,
                                  joint_transform=transform_joint)
    return DiMPSampler(datasets, samples_per_epoch=samples_per_epoch, max_gap=200,
                       num_test_frames=3, num_train_frames=3, processing=processing, seed=seed)


def make_net(settings: Settings, device="cuda"):
    """The seeded PrDiMP-50 at the settings' label sigma
    (output_sigma_factor / search_area_factor * feature_sz cells)."""
    output_sigma = settings.output_sigma_factor / settings.search_area_factor
    return klcedimpnet50(device=device, filter_size=settings.target_filter_sz,
                         gauss_sigma=output_sigma * settings.feature_sz)


def make_actor(settings: Settings):
    """The recipe's actor, as a function of the net."""
    return KLDiMPActor


def run(settings: Settings, datasets=None, max_epochs: int = 50,
        samples_per_epoch: int = 2000, net=None, device="cuda"):
    device = resolve_device(device)
    settings.description = getattr(settings, "description", None) or \
        "PrDiMP-50 (reference recipe defaults)"
    sampler = make_sampler(settings, datasets, samples_per_epoch)
    net = net if net is not None else make_net(settings, device)
    return train_recipe(settings, sampler, net, make_actor(settings), BASE_LR, MODULE_LRS,
                        max_epochs, device, freeze_unlisted=FREEZE_UNLISTED)
