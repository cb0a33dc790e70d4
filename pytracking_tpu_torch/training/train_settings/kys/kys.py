"""KYS's training recipe (counterpart of
pytracking_tpu/training/train_settings/kys/kys.py): 3 train frames within 30
frames before 10 consecutive test frames (occlusion-spanning sub-sequences
where the dataset marks occlusions, missing targets allowed), 288x288 crops
under a synthetic camera motion (the test frames' motion limited), Gaussian
labels zeroed on the frames without a visible target, the appearance
model's scores jittered (a distractor raised with probability 0.3), and
Adam at 1e-2 on the response predictor alone, decayed by 0.2 every 15
epochs; the DiMP part (backbone, classifier, IoU-Net) is frozen.

One deviation from the JAX recipe: the labels are not end-padded
(`end_pad_if_even` False), so they lie on the 18x18 grid of the motion
features. The JAX recipe's default padding makes them 19x19, and its
actor cannot carry such a label's state on the 18x18 grid (it raises).

It trains on the procedural SyntheticVideoDataset unless `datasets` are
given; `net` replaces the seeded KYS.
"""

from __future__ import annotations

from pytracking_tpu_torch.models.kys.score_jitter import DiMPScoreJittering
from pytracking_tpu_torch.models.tracking.kysnet import kysnet_res50
from pytracking_tpu_torch.training import transforms as tfm
from pytracking_tpu_torch.training.actors.tracking import KYSActor
from pytracking_tpu_torch.training.datasets.synthetic_video import SyntheticVideoDataset
from pytracking_tpu_torch.training.processing import KYSProcessing
from pytracking_tpu_torch.training.sampler import KYSSampler
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.trainer import train_recipe
from pytracking_tpu_torch.utils.device import resolve_device

# Adam's learning rate per module; the rest of the net is frozen
BASE_LR = 1e-2
MODULE_LRS = {"predictor": 1e-2}
FREEZE_UNLISTED = True
STEP_SIZE = 15
NUM_TEST_FRAMES = 10


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000, seed=None,
                 num_test_frames: int = NUM_TEST_FRAMES) -> KYSSampler:
    """The recipe's sampler and processing (seed: its generators' seed, None
    for the OS's entropy)."""
    datasets = datasets or [SyntheticVideoDataset(num_sequences=128, seq_len=60)]
    label_params = {"feature_sz": settings.feature_sz,
                    "sigma_factor": settings.output_sigma_factor / settings.search_area_factor,
                    "kernel_sz": settings.target_filter_sz, "end_pad_if_even": False}
    processing = KYSProcessing(search_area_factor=settings.search_area_factor,
                               output_sz=settings.output_sz,
                               center_jitter_param={"train_factor": 3.0, "train_mode": "uniform",
                                                    "test_factor": 4.5,
                                                    "test_limit_motion": True,
                                                    "test_mode": "uniform"},
                               scale_jitter_param={"train_factor": 0.25, "test_factor": 0.3},
                               label_function_params=label_params, min_crop_inside_ratio=0.1,
                               train_transform=tfm.Transform(tfm.BrightnessJitter(0.2)),
                               joint_transform=tfm.Transform(tfm.ToGrayscale(probability=0.05)))
    return KYSSampler(datasets, samples_per_epoch=samples_per_epoch,
                      sequence_sample_info={"num_train_frames": 3,
                                            "num_test_frames": num_test_frames,
                                            "max_train_gap": 30, "allow_missing_target": True,
                                            "min_fraction_valid_frames": 0.5,
                                            "mode": "Sequence"},
                      processing=processing, sample_occluded_sequences=True, seed=seed)


def make_net(settings: Settings, device="cuda"):
    """The seeded KYS with 3 steepest-descent steps in its classifier."""
    return kysnet_res50(optim_iter=3, device=device)


def make_actor(settings: Settings, jitter: bool = True, generator_device=None):
    """The recipe's actor, as a function of the net: KYSActor with the
    score jitter (distractor ratio 0.1, probability 0.3, enhanced to
    0.8-1.3 times the target's peak), or without it."""
    score_jitter = DiMPScoreJittering(distractor_ratio=0.1, p_distractor=0.3,
                                      max_distractor_enhance_factor=1.3,
                                      min_distractor_enhance_factor=0.8) if jitter else None
    return lambda net: KYSActor(net, jitter=score_jitter, generator_device=generator_device)


def run(settings: Settings, datasets=None, max_epochs: int = 40,
        samples_per_epoch: int = 2000, net=None, device="cuda",
        num_test_frames: int = NUM_TEST_FRAMES):
    device = resolve_device(device)
    settings.description = getattr(settings, "description", None) or \
        "KYS (reference recipe defaults)"
    sampler = make_sampler(settings, datasets, samples_per_epoch,
                           num_test_frames=num_test_frames)
    net = net if net is not None else make_net(settings, device)
    return train_recipe(settings, sampler, net, make_actor(settings), BASE_LR, MODULE_LRS,
                        max_epochs, device, freeze_unlisted=FREEZE_UNLISTED,
                        step_size=STEP_SIZE)
