"""ToMP-50's training recipe (counterpart of
pytracking_tpu/training/train_settings/tomp/tomp50.py): 2 train and 1 test
frame per sequence (within 200 frames), 288x288 crops at search area 5,
Gaussian labels and dense LTRB maps at stride 16, the GIoU + LBHinge
objective with the transformer's dropout on, and AdamW (weight decay 1e-4)
on the head (1e-4) and the backbone's layer3 (2e-5), everything else frozen,
decayed by 0.2 at epochs 150 and 250. The backbone's BatchNorms stay in
eval mode. It trains on the procedural SyntheticVideoDataset unless
`datasets` are given; `net` replaces the seeded ToMP-50.
"""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.tompnet import tompnet50
from pytracking_tpu_torch.training import transforms as tfm
from pytracking_tpu_torch.training.actors.tracking import ToMPActor
from pytracking_tpu_torch.training.datasets.synthetic_video import SyntheticVideoDataset
from pytracking_tpu_torch.training.processing import ToMPProcessing
from pytracking_tpu_torch.training.sampler import DiMPSampler
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.trainer import train_recipe
from pytracking_tpu_torch.utils.device import resolve_device

# AdamW's learning rate per module; the rest of the net is frozen
BASE_LR = 2e-4
MODULE_LRS = {"head": 1e-4, "feature_extractor.layer3_": 2e-5}
FREEZE_UNLISTED = True
WEIGHT_DECAY = 1e-4
MILESTONES = (150, 250)


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000,
                 seed=None) -> DiMPSampler:
    """The recipe's sampler and processing (seed: its generators' seed, None
    for the OS's entropy)."""
    datasets = datasets or [SyntheticVideoDataset(num_sequences=256, seq_len=40)]
    transform_joint = tfm.Transform(tfm.ToGrayscale(probability=0.05))
    transform_train = tfm.Transform(tfm.BrightnessJitter(0.2), tfm.RandomHorizontalFlip(0.5))
    output_sigma = settings.output_sigma_factor / settings.search_area_factor
    label_params = {"feature_sz": settings.feature_sz, "sigma_factor": output_sigma,
                    "kernel_sz": 1, "stride": 16}
    processing = ToMPProcessing(search_area_factor=settings.search_area_factor,
                                output_sz=settings.output_sz,
                                center_jitter_factor=settings.center_jitter_factor,
                                scale_jitter_factor=settings.scale_jitter_factor,
                                label_function_params=label_params,
                                train_transform=transform_train,
                                joint_transform=transform_joint)
    return DiMPSampler(datasets, samples_per_epoch=samples_per_epoch, max_gap=200,
                       num_test_frames=1, num_train_frames=2, processing=processing, seed=seed)


def make_net(settings: Settings, device="cuda"):
    """The seeded ToMP-50 with its backbone's BatchNorms frozen."""
    return tompnet50(feature_sz=settings.feature_sz, freeze_backbone_bn=True, device=device)


def make_actor(settings: Settings):
    """The recipe's actor, as a function of the net."""
    return ToMPActor


def run(settings: Settings, datasets=None, max_epochs: int = 300,
        samples_per_epoch: int = 2000, net=None, device="cuda"):
    device = resolve_device(device)
    settings.description = getattr(settings, "description", None) or \
        "ToMP-50 (reference recipe defaults)"
    sampler = make_sampler(settings, datasets, samples_per_epoch)
    net = net if net is not None else make_net(settings, device)
    return train_recipe(settings, sampler, net, make_actor(settings), BASE_LR, MODULE_LRS,
                        max_epochs, device, freeze_unlisted=FREEZE_UNLISTED,
                        milestones=MILESTONES, weight_decay=WEIGHT_DECAY)
