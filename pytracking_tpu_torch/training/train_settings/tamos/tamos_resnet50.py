"""TaMOs-ResNet50's training recipe (counterpart of
pytracking_tpu/training/train_settings/tamos/tamos_resnet50.py): K = 3
object slots, one train and one test frame per sequence (the test frame
within 200 frames after the train frame), 288x288 crops at search area 5
(one crop per frame around its lowest object id), slot-first labels and
LTRB maps at stride 16 on the train side, slot-last ones and sample regions
at stride 8 (the FPN's level) on the test side, the GIoU + LBHinge objective
over the slots with a target, the transformer's dropout on, and AdamW
(weight decay 1e-4) on the head modules (1e-4) and the backbone's layer3
(2e-5), everything else frozen, decayed by 0.2 at epochs 150 and 250. The
backbone's BatchNorms stay in eval mode. It trains on the procedural
SyntheticVideoDataset (one object: slot 0) unless `datasets` are given;
`net` replaces the seeded TaMOs-ResNet50.
"""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.tamosnet import tamosnet_resnet50
from pytracking_tpu_torch.training import transforms as tfm
from pytracking_tpu_torch.training.actors.tracking import TaMOsActor
from pytracking_tpu_torch.training.datasets.synthetic_video import SyntheticVideoDataset
from pytracking_tpu_torch.training.processing import TaMOsProcessing
from pytracking_tpu_torch.training.sampler import TaMOsDatasetSampler
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.trainer import train_recipe
from pytracking_tpu_torch.utils.device import resolve_device

NUM_OBJECTS = 3
OUTPUT_SZ = 288
# AdamW's learning rate per module ("head" in the reference: all but the
# backbone); the rest of the net is frozen
BASE_LR = 2e-4
MODULE_LRS = {"head_feature_extractor": 1e-4, "filter_predictor": 1e-4, "classifier": 1e-4,
              "bb_regressor": 1e-4, "fpn": 1e-4, "feature_extractor.layer3_": 2e-5}
FREEZE_UNLISTED = True
WEIGHT_DECAY = 1e-4
MILESTONES = (150, 250)


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000,
                 seed=None, num_objects: int = NUM_OBJECTS) -> TaMOsDatasetSampler:
    """The recipe's sampler and processing at the settings' output_sz and
    feature_sz (seed: its generators' seed, None for the OS's entropy)."""
    datasets = datasets or [SyntheticVideoDataset(num_sequences=128, seq_len=40)]
    output_sigma = settings.output_sigma_factor / settings.search_area_factor
    label_params = {"feature_sz": settings.feature_sz, "sigma_factor": output_sigma,
                    "kernel_sz": 1, "stride": 16}
    processing = TaMOsProcessing(search_area_factor=settings.search_area_factor,
                                 output_sz=settings.output_sz,
                                 center_jitter_factor=settings.center_jitter_factor,
                                 scale_jitter_factor=settings.scale_jitter_factor,
                                 label_function_params=label_params,
                                 num_objects=num_objects, stride_high=8,
                                 train_transform=tfm.Transform(tfm.BrightnessJitter(0.2),
                                                               tfm.RandomHorizontalFlip(0.5)),
                                 joint_transform=tfm.Transform(tfm.ToGrayscale(probability=0.05)))
    return TaMOsDatasetSampler(datasets, samples_per_epoch=samples_per_epoch, max_gap=200,
                               num_test_frames=1, num_train_frames=1, processing=processing,
                               seed=seed)


def make_net(settings: Settings, device="cuda", num_objects: int = NUM_OBJECTS):
    """The seeded TaMOs-ResNet50 with its backbone's BatchNorms frozen."""
    return tamosnet_resnet50(num_tokens=num_objects, feature_sz=settings.feature_sz,
                             freeze_backbone_bn=True, device=device)


def make_actor(settings: Settings):
    """The recipe's actor, as a function of the net."""
    return TaMOsActor


def run(settings: Settings, datasets=None, max_epochs: int = 100,
        samples_per_epoch: int = 2000, net=None, device="cuda",
        num_objects: int = NUM_OBJECTS, output_sz: int = OUTPUT_SZ):
    """Sets settings.output_sz to `output_sz` and settings.feature_sz to
    output_sz // 16, as the JAX recipe does."""
    device = resolve_device(device)
    settings.description = getattr(settings, "description", None) or \
        "TaMOs-ResNet-50 (reference recipe defaults)"
    settings.output_sz = output_sz
    settings.feature_sz = output_sz // 16
    sampler = make_sampler(settings, datasets, samples_per_epoch, num_objects=num_objects)
    net = net if net is not None else make_net(settings, device, num_objects)
    return train_recipe(settings, sampler, net, make_actor(settings), BASE_LR, MODULE_LRS,
                        max_epochs, device, freeze_unlisted=FREEZE_UNLISTED,
                        milestones=MILESTONES, weight_decay=WEIGHT_DECAY)
