"""LWL's stage-1 training recipe (counterpart of
pytracking_tpu/training/train_settings/lwl/lwl_stage1.py): one train and
three test frames per sequence (within 100 frames), 352x352 crops at search
area 5 with their masks, 5% grayscale over each split and a horizontal flip
of half the crops (masks with their images), the Lovász hinge on the test
frames' masks without refinement of the target model, and Adam on the
target model's feature block (2e-5), the rest of the target model (its
regulariser, 1e-4), the decoder (1e-4) and the label encoder (2e-4),
everything else frozen, decayed by 0.2 at epoch 40. The backbone's
BatchNorms run in train mode (frozen weights, moving statistics), as in the
JAX recipe. It trains on the procedural SyntheticVOSVideoDataset unless
`datasets` are given; `net` replaces the seeded LWL.
"""

from __future__ import annotations

import functools

from pytracking_tpu_torch.models.lwl.lwl_net import steepest_descent_resnet50
from pytracking_tpu_torch.training import transforms as tfm
from pytracking_tpu_torch.training.actors.tracking import LWLActor
from pytracking_tpu_torch.training.datasets.synthetic_video import SyntheticVOSVideoDataset
from pytracking_tpu_torch.training.processing import LWLProcessing
from pytracking_tpu_torch.training.sampler import LWLSampler
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.trainer import train_recipe
from pytracking_tpu_torch.utils.device import resolve_device

OUTPUT_SZ = 352
NUM_REFINEMENT_ITER = 0
# Adam's learning rate per module; the rest of the net is frozen
BASE_LR = 2e-4
MODULE_LRS = {"target_model.feature_extractor": 2e-5, "target_model": 1e-4, "decoder": 1e-4,
              "label_encoder": 2e-4}
FREEZE_UNLISTED = True
MILESTONES = (40,)


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000,
                 seed=None, output_sz: int = OUTPUT_SZ, num_test_frames: int = 3,
                 processing_cls=LWLProcessing, label_function_params=None) -> LWLSampler:
    """The recipe's sampler and processing at `output_sz` (seed: its
    generators' seed, None for the OS's entropy). RTS's recipe passes its
    processing class and label parameters."""
    datasets = datasets or [SyntheticVOSVideoDataset(num_sequences=128, seq_len=40)]
    processing = processing_cls(search_area_factor=settings.search_area_factor,
                                output_sz=output_sz,
                                center_jitter_factor=settings.center_jitter_factor,
                                scale_jitter_factor=settings.scale_jitter_factor,
                                label_function_params=label_function_params,
                                train_transform=tfm.Transform(tfm.RandomHorizontalFlip(0.5)),
                                joint_transform=tfm.Transform(tfm.ToGrayscale(probability=0.05)))
    return LWLSampler(datasets, samples_per_epoch=samples_per_epoch, max_gap=100,
                      num_test_frames=num_test_frames, num_train_frames=1,
                      processing=processing, seed=seed)


def make_net(settings: Settings, device="cuda"):
    """The seeded LWL: 3x3 filters of 16 channels, 5 learner steps."""
    return steepest_descent_resnet50(filter_size=3, num_filters=16, optim_iter=5, device=device)


def make_actor(settings: Settings, num_refinement_iter: int = NUM_REFINEMENT_ITER):
    """The recipe's actor, as a function of the net."""
    return functools.partial(LWLActor, num_refinement_iter=num_refinement_iter)


def run(settings: Settings, datasets=None, max_epochs: int = 70,
        samples_per_epoch: int = 2000, net=None, device="cuda",
        num_refinement_iter: int = NUM_REFINEMENT_ITER, output_sz: int = OUTPUT_SZ,
        num_test_frames: int = 3):
    """Sets settings.output_sz to `output_sz`, as the JAX recipe does."""
    device = resolve_device(device)
    settings.description = getattr(settings, "description", None) or \
        "LWL stage 1 (reference recipe defaults)"
    settings.output_sz = output_sz
    sampler = make_sampler(settings, datasets, samples_per_epoch, output_sz=output_sz,
                           num_test_frames=num_test_frames)
    net = net if net is not None else make_net(settings, device)
    return train_recipe(settings, sampler, net, make_actor(settings, num_refinement_iter),
                        BASE_LR, MODULE_LRS, max_epochs, device,
                        freeze_unlisted=FREEZE_UNLISTED, milestones=MILESTONES)
