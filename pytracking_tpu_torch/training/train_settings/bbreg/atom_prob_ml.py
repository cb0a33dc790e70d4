"""ATOM's probabilistic-ML recipe (counterpart of
pytracking_tpu/training/train_settings/bbreg/atom_prob_ml.py): the IoU
head trained as a density predictor with the KL objective over 128
proposals per test frame drawn from a two-component Gaussian mixture
(PrDiMP's processing without labels), ATOM's sampler and frozen
backbone."""

from __future__ import annotations

from typing import Dict

import torch

from pytracking_tpu_torch.models.loss.kl_regression import kl_regression
from pytracking_tpu_torch.training import transforms as tfm
from pytracking_tpu_torch.training.datasets.synthetic_video import SyntheticVideoDataset
from pytracking_tpu_torch.training.processing import KLDiMPProcessing
from pytracking_tpu_torch.training.sampler import ATOMSampler
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.bbreg import atom
from pytracking_tpu_torch.training.trainer import train_recipe
from pytracking_tpu_torch.utils.device import resolve_device

make_net = atom.make_net
BASE_LR, MODULE_LRS, FREEZE_UNLISTED = atom.BASE_LR, atom.MODULE_LRS, atom.FREEZE_UNLISTED


class ATOMBBKLActor:
    """The KL regression of the IoU-Net's scores on the proposal densities
    (counterpart of the JAX recipe's `make_atom_bbkl_actor`). The stats:
    Loss/total and Loss/bb_ce (the same value)."""

    def __init__(self, net):
        self.net = net

    def __call__(self, batch: Dict[str, torch.Tensor]):
        bb_scores = self.net(batch["train_images"], batch["test_images"], batch["train_anno"],
                             batch["test_proposals"])
        loss = kl_regression(bb_scores, batch["proposal_density"], batch["gt_density"],
                             mc_dim=-1)
        return loss, {"Loss/total": loss, "Loss/bb_ce": loss}


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000,
                 seed=None) -> ATOMSampler:
    datasets = datasets or [SyntheticVideoDataset(num_sequences=256, seq_len=40)]
    processing = KLDiMPProcessing(search_area_factor=settings.search_area_factor,
                                  output_sz=settings.output_sz,
                                  center_jitter_factor=settings.center_jitter_factor,
                                  scale_jitter_factor=settings.scale_jitter_factor,
                                  proposal_params={"boxes_per_frame": 128,
                                                   "proposal_sigma": [(0.05, 0.05), (0.5, 0.5)]},
                                  train_transform=tfm.Transform(tfm.BrightnessJitter(0.2)),
                                  joint_transform=tfm.Transform(
                                      tfm.ToGrayscale(probability=0.05)))
    return ATOMSampler(datasets, samples_per_epoch=samples_per_epoch, max_gap=50,
                       processing=processing, seed=seed)


def make_actor(settings: Settings):
    """The recipe's actor, as a function of the net."""
    return ATOMBBKLActor


def run(settings: Settings, datasets=None, max_epochs: int = 50,
        samples_per_epoch: int = 2000, net=None, device="cuda"):
    device = resolve_device(device)
    settings.description = getattr(settings, "description", None) or \
        "ATOM prob-ML (reference recipe defaults)"
    sampler = make_sampler(settings, datasets, samples_per_epoch)
    net = net if net is not None else make_net(settings, device)
    return train_recipe(settings, sampler, net, make_actor(settings), BASE_LR, MODULE_LRS,
                        max_epochs, device, freeze_unlisted=FREEZE_UNLISTED)
