"""DiMP-50's training recipe (counterpart of
pytracking_tpu/training/train_settings/dimp/dimp50.py): 3 train and 3 test
frames per sequence, 288x288 crops at search area 5, 8 IoU-Net proposals
per test frame, Adam with per-module learning rates and a decay of 0.2
every 15 epochs. It trains on the procedural SyntheticVideoDataset unless
`datasets` are given; `net` replaces the seeded DiMP-50.
"""

from __future__ import annotations

from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50
from pytracking_tpu_torch.training import transforms as tfm
from pytracking_tpu_torch.training.actors.tracking import DiMPActor
from pytracking_tpu_torch.training.datasets.synthetic_video import SyntheticVideoDataset
from pytracking_tpu_torch.training.loader import LTRLoader
from pytracking_tpu_torch.training.optim import adam_per_module
from pytracking_tpu_torch.training.processing import DiMPProcessing
from pytracking_tpu_torch.training.sampler import DiMPSampler
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.trainer import LTRTrainer
from pytracking_tpu_torch.utils.device import resolve_device


# Adam's learning rate per module; the rest of the net trains at BASE_LR
BASE_LR = 2e-4
MODULE_LRS = {"classifier.filter_initializer": 5e-5, "classifier.filter_optimizer": 5e-4,
              "classifier.feature_extractor": 5e-5, "feature_extractor": 2e-5}


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000,
                 seed=None) -> DiMPSampler:
    """The recipe's sampler and processing (seed: its generators' seed, None
    for the OS's entropy)."""
    datasets = datasets or [SyntheticVideoDataset(num_sequences=256, seq_len=40)]
    transform_joint = tfm.Transform(tfm.ToGrayscale(probability=0.05))
    transform_train = tfm.Transform(tfm.BrightnessJitter(0.2), tfm.RandomHorizontalFlip(0.5))

    output_sigma = settings.output_sigma_factor / settings.search_area_factor
    proposal_params = {"min_iou": 0.1, "boxes_per_frame": 8, "proposal_sigma": 0.05}
    label_params = {"feature_sz": settings.feature_sz, "sigma_factor": output_sigma,
                    "kernel_sz": settings.target_filter_sz}
    processing = DiMPProcessing(search_area_factor=settings.search_area_factor,
                                output_sz=settings.output_sz,
                                center_jitter_factor=settings.center_jitter_factor,
                                scale_jitter_factor=settings.scale_jitter_factor,
                                proposal_params=proposal_params,
                                label_function_params=label_params,
                                train_transform=transform_train,
                                joint_transform=transform_joint)
    return DiMPSampler(datasets, samples_per_epoch=samples_per_epoch, max_gap=30,
                       num_test_frames=3, num_train_frames=3, processing=processing, seed=seed)


def run(settings: Settings, datasets=None, max_epochs: int = 50,
        samples_per_epoch: int = 2000, net=None, device="cuda"):
    device = resolve_device(device)
    settings.description = "DiMP-50 (reference recipe defaults)"
    loader = LTRLoader("train", make_sampler(settings, datasets, samples_per_epoch),
                       training=True, batch_size=settings.batch_size,
                       num_workers=settings.num_workers)

    output_sigma = settings.output_sigma_factor / settings.search_area_factor
    if net is None:
        net = dimpnet50(device=device, filter_size=settings.target_filter_sz, optim_iter=5,
                        init_gauss_sigma=output_sigma * settings.feature_sz,
                        num_dist_bins=100, bin_displacement=0.1, mask_init_factor=3.0)
    net = net.to(device)
    actor = DiMPActor(net, hinge_threshold=settings.hinge_threshold)

    optimizer, scheduler = adam_per_module(net, BASE_LR, MODULE_LRS,
                                           steps_per_epoch=len(loader), step_size=15,
                                           gamma=0.2)

    trainer = LTRTrainer(actor, [loader], optimizer, settings, settings.checkpoint_dir,
                         scheduler=scheduler, device=device,
                         print_interval=settings.print_interval)
    trainer.train(max_epochs, load_latest=True, fail_safe=True)
    return trainer
