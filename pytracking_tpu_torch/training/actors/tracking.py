"""Actors: the training loss on top of a net's forward (counterpart of
pytracking_tpu/training/actors/tracking.py `make_dimp_actor`,
`make_atom_actor`, `make_kldimp_actor`).

An actor is called on a batch on the device and returns (loss, stats),
both device tensors; the train step differentiates the loss with autograd
and reads the stats back once. Batch layout, frame-major: train_images
(Ntrain, S, 3, H, W) and test_images (Ntest, S, 3, H, W) in 0-255,
train_anno (Ntrain, S, 4), test_proposals (Ntest, S, P, 4), proposal_iou
(Ntest, S, P), test_label (Ntest, S, h, w); PrDiMP's processing gives
proposal_density and gt_density (Ntest, S, P) and test_label_density
(Ntest, S, h, w) instead of proposal_iou and test_label.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pytracking_tpu_torch.models.loss.kl_regression import kl_regression, kl_regression_grid
from pytracking_tpu_torch.models.loss.target_classification import (
    lbhinge, tracking_classification_accuracy)


class DiMPActor:
    """DiMP's objective: the IoU predictions' squared error, plus the
    LBHinge classification loss of the filter iterates on the test frames
    (weights: iou 1, the final iterate 100, the first 100, the mean of the
    ones between 400, that last only with more than 2 iterates). The
    stats: Loss/total, Loss/iou, Loss/target_clf (weighted), and
    ClfTrain/test_acc of the final iterate's score peaks."""

    def __init__(self, net, loss_weight: Optional[Dict[str, float]] = None,
                 hinge_threshold: float = 0.05):
        self.net = net
        self.loss_weight = loss_weight or {"iou": 1.0, "test_clf": 100.0,
                                           "test_init_clf": 100.0, "test_iter_clf": 400.0}
        self.hinge_threshold = hinge_threshold

    def __call__(self, batch: Dict[str, torch.Tensor]):
        target_scores, iou_pred = self.net(batch["train_images"], batch["test_images"],
                                           batch["train_anno"], batch["test_proposals"])
        w = self.loss_weight
        loss_iou = torch.mean((iou_pred - batch["proposal_iou"]) ** 2)

        label = batch["test_label"][:, :, None]                # (Ntest, S, 1, h, w)
        clf_losses = [lbhinge(s, label, self.hinge_threshold) for s in target_scores]
        loss_target_clf = w.get("test_clf", 0) * clf_losses[-1]
        loss_init_clf = w.get("test_init_clf", 0) * clf_losses[0]
        loss_iter_clf = w.get("test_iter_clf", 0) * torch.stack(clf_losses[1:-1]).mean() \
            if len(clf_losses) > 2 else 0.0

        loss = w.get("iou", 0) * loss_iou + loss_target_clf + loss_init_clf + loss_iter_clf
        acc = tracking_classification_accuracy(target_scores[-1][:, :, 0], batch["test_label"])
        stats = {"Loss/total": loss, "Loss/iou": loss_iou, "Loss/target_clf": loss_target_clf,
                 "ClfTrain/test_acc": acc}
        return loss, stats


class ATOMActor:
    """ATOM's objective: the squared error of the IoU predictions. The
    stats: Loss/total and Loss/iou (the same value)."""

    def __init__(self, net):
        self.net = net

    def __call__(self, batch: Dict[str, torch.Tensor]):
        iou_pred = self.net(batch["train_images"], batch["test_images"], batch["train_anno"],
                            batch["test_proposals"])
        loss = torch.mean((iou_pred - batch["proposal_iou"]) ** 2)
        return loss, {"Loss/total": loss, "Loss/iou": loss}


class KLDiMPActor:
    """PrDiMP's objective: the KL regression of the IoU-Net's scores on the
    proposal densities (weight bb_ce 0.01), plus the KL divergence on the
    score grid of every filter iterate's test scores from the label density
    (the final iterate 100, the first 100, the mean of the ones between
    400, that last only with more than 2 iterates). Any of the three
    optimisers' iterates serve. The stats: Loss/total, Loss/bb_ce and
    Loss/target_clf (the final iterate's, unweighted)."""

    def __init__(self, net, loss_weight: Optional[Dict[str, float]] = None):
        self.net = net
        self.loss_weight = loss_weight or {"bb_ce": 0.01, "test_clf": 100.0,
                                           "test_init_clf": 100.0, "test_iter_clf": 400.0}

    def __call__(self, batch: Dict[str, torch.Tensor]):
        target_scores, bb_scores = self.net(batch["train_images"], batch["test_images"],
                                            batch["train_anno"], batch["test_proposals"])
        w = self.loss_weight
        bb_ce = kl_regression(bb_scores, batch["proposal_density"], batch["gt_density"],
                              mc_dim=-1)
        clf = [kl_regression_grid(s[:, :, 0], batch["test_label_density"])
               for s in target_scores]
        loss_clf = w["test_clf"] * clf[-1] + w["test_init_clf"] * clf[0]
        if len(clf) > 2:
            loss_clf = loss_clf + w["test_iter_clf"] * torch.stack(clf[1:-1]).mean()
        loss = w["bb_ce"] * bb_ce + loss_clf
        return loss, {"Loss/total": loss, "Loss/bb_ce": bb_ce, "Loss/target_clf": clf[-1]}
