"""ATOM's IoU-Net training recipe (counterpart of
pytracking_tpu/training/train_settings/bbreg/atom.py): one train and one
test frame per sequence (within 50 frames), 288x288 crops at search area 5,
16 IoU-Net proposals per test frame with IoU at least 0.1, the IoU
predictions' squared error, and Adam on the IoU-Net alone (1e-3, decayed
by 0.2 every 15 epochs): the ResNet-18 backbone's weights are frozen, its
BatchNorm trains (running statistics move) as the JAX actor's does. It
trains on the procedural SyntheticVideoDataset unless `datasets` are
given; `net` replaces the seeded ATOM.
"""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.atomnet import atom_resnet18
from pytracking_tpu_torch.training import transforms as tfm
from pytracking_tpu_torch.training.actors.tracking import ATOMActor
from pytracking_tpu_torch.training.datasets.synthetic_video import SyntheticVideoDataset
from pytracking_tpu_torch.training.processing import ATOMProcessing
from pytracking_tpu_torch.training.sampler import ATOMSampler
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.trainer import train_recipe
from pytracking_tpu_torch.utils.device import resolve_device


# only the IoU-Net trains; the rest of the net is frozen
BASE_LR = 1e-3
MODULE_LRS = {"bb_regressor": 1e-3}
FREEZE_UNLISTED = True


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000,
                 seed=None) -> ATOMSampler:
    """The recipe's sampler and processing (seed: its generators' seed, None
    for the OS's entropy)."""
    datasets = datasets or [SyntheticVideoDataset(num_sequences=256, seq_len=40)]
    processing = ATOMProcessing(search_area_factor=settings.search_area_factor,
                                output_sz=settings.output_sz,
                                center_jitter_factor=settings.center_jitter_factor,
                                scale_jitter_factor=settings.scale_jitter_factor,
                                proposal_params={"min_iou": 0.1, "boxes_per_frame": 16,
                                                 "proposal_sigma": 0.05},
                                train_transform=tfm.Transform(tfm.BrightnessJitter(0.2)),
                                joint_transform=tfm.Transform(tfm.ToGrayscale(probability=0.05)))
    return ATOMSampler(datasets, samples_per_epoch=samples_per_epoch, max_gap=50,
                       processing=processing, seed=seed)


def make_net(settings: Settings, device="cuda"):
    return atom_resnet18(device=device)


def make_actor(settings: Settings):
    """The recipe's actor, as a function of the net."""
    return ATOMActor


def run(settings: Settings, datasets=None, max_epochs: int = 50,
        samples_per_epoch: int = 2000, net=None, device="cuda"):
    device = resolve_device(device)
    settings.description = getattr(settings, "description", None) or \
        "ATOM IoUNet (reference recipe defaults)"
    sampler = make_sampler(settings, datasets, samples_per_epoch)
    net = net if net is not None else make_net(settings, device)
    return train_recipe(settings, sampler, net, make_actor(settings), BASE_LR, MODULE_LRS,
                        max_epochs, device, freeze_unlisted=FREEZE_UNLISTED)
