"""Actors: the training loss on top of a net's forward (counterpart of
pytracking_tpu/training/actors/tracking.py `make_dimp_actor`,
`make_atom_actor`, `make_kldimp_actor`, `make_tomp_actor`,
`make_tamos_actor`, `make_lwl_actor`, `make_rts_actor`, `make_lwl_box_actor`).

An actor is called on a batch on the device and returns (loss, stats),
both device tensors; the train step differentiates the loss with autograd
and reads the stats back once. Batch layout, frame-major: train_images
(Ntrain, S, 3, H, W) and test_images (Ntest, S, 3, H, W) in 0-255,
train_anno (Ntrain, S, 4), test_proposals (Ntest, S, P, 4), proposal_iou
(Ntest, S, P), test_label (Ntest, S, h, w); PrDiMP's processing gives
proposal_density and gt_density (Ntest, S, P) and test_label_density
(Ntest, S, h, w) instead of proposal_iou and test_label. ToMP's,
TaMOs's and the segmentation actors' are in their docstrings.

The trainer puts the step's dropout seed in the batch as 'rng_seed' (a
host int); the actors of nets with dropout seed their own generator on the
net's device with it, so a resumed run draws the same masks.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pytracking_tpu_torch.models.loss.bbr_loss import giou_loss
from pytracking_tpu_torch.models.loss.kl_regression import kl_regression, kl_regression_grid
from pytracking_tpu_torch.models.loss.segmentation import lovasz_seg_loss
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


class _DropoutActor:
    """An actor whose net draws dropout masks in train mode: a generator on
    the net's device, seeded per step with the batch's 'rng_seed' (0
    without one). Seeding a device generator is a host-side state change:
    no synchronisation."""

    def __init__(self, net):
        self.net = net
        self._generator: Optional[torch.Generator] = None

    def generator(self, batch: Dict[str, torch.Tensor]) -> torch.Generator:
        device = next(self.net.parameters()).device
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
        self._generator.manual_seed(int(batch.get("rng_seed", 0)))
        return self._generator


class ToMPActor(_DropoutActor):
    """ToMP's objective: GIoU of the dense box predictions over the test
    positions where all four target LTRB distances are positive (inside the
    box; weight 1), plus LBHinge of the test scores on the Gaussian labels
    (weight 100). Batch: train_images (Ntr, S, 3, H, W), test_images (Nte,
    S, 3, H, W), train_label (Ntr, S, h, w), train_ltrb_target (Ntr, S, h,
    w, 4), test_label (Nte, S, h, w), test_ltrb_target (Nte, S, h, w, 4).
    The stats, under the JAX names: Loss/total, Loss/giou, Loss/target_clf
    (unweighted) and ClfTrain/test_acc."""

    def __init__(self, net, loss_weight: Optional[Dict[str, float]] = None):
        super().__init__(net)
        self.loss_weight = loss_weight or {"bb_ce": 0.01, "giou": 1.0, "test_clf": 100.0}

    def __call__(self, batch: Dict[str, torch.Tensor]):
        scores, bbox_preds = self.net(batch["train_images"], batch["test_images"],
                                      batch["train_label"], batch["train_ltrb_target"],
                                      generator=self.generator(batch))
        target_ltrb = batch["test_ltrb_target"]
        inside = torch.all(target_ltrb > 0, dim=-1)
        loss_giou = giou_loss(bbox_preds.movedim(2, -1), target_ltrb, inside)
        loss_clf = lbhinge(scores, batch["test_label"])
        w = self.loss_weight
        loss = w["giou"] * loss_giou + w["test_clf"] * loss_clf
        acc = tracking_classification_accuracy(scores, batch["test_label"])
        return loss, {"Loss/total": loss, "Loss/giou": loss_giou, "Loss/target_clf": loss_clf,
                      "ClfTrain/test_acc": acc}


class TaMOsActor(_DropoutActor):
    """TaMOs's objective: GIoU of every slot's dense box predictions over its
    test sample region (weight 1), plus LBHinge of the slots' test scores
    (weight 100) with every slot whose label never exceeds 0.05 in a frame
    masked out (scores and labels zeroed). Batch: train_images (Ntr, S, 3,
    H, W), test_images (Nte, S, 3, H, W), train_label (Ntr, S, K, h, w),
    train_ltrb_target (Ntr, S, K, h, w, 4), test_label and
    test_sample_region (Nte, S, 2h, 2w, K), test_ltrb_target (Nte, S, 2h,
    2w, K, 4). The stats: Loss/total, Loss/giou, Loss/target_clf
    (unweighted)."""

    def __init__(self, net, loss_weight: Optional[Dict[str, float]] = None):
        super().__init__(net)
        self.loss_weight = loss_weight or {"giou": 1.0, "test_clf": 100.0}

    def __call__(self, batch: Dict[str, torch.Tensor]):
        scores, bbox_preds = self.net(batch["train_images"], batch["test_images"],
                                      batch["train_label"], batch["train_ltrb_target"],
                                      generator=self.generator(batch))
        scores = scores.movedim(2, -1)                         # (Nte, S, 2h, 2w, K)
        bbox_preds = bbox_preds.permute(0, 1, 4, 5, 2, 3)      # (Nte, S, 2h, 2w, K, 4)
        loss_giou = giou_loss(bbox_preds, batch["test_ltrb_target"],
                              batch["test_sample_region"])
        label = batch["test_label"]
        active = (label.amax(dim=(2, 3), keepdim=True) > 0.05).to(scores.dtype)
        loss_clf = lbhinge(scores * active, label * active)
        w = self.loss_weight
        loss = w["giou"] * loss_giou + w["test_clf"] * loss_clf
        return loss, {"Loss/total": loss, "Loss/giou": loss_giou, "Loss/target_clf": loss_clf}


class LWLActor:
    """LWL's objective: the Lovász hinge of the test frames' predicted masks
    (weight 100), the target model refined `num_refinement_iter` steps after
    each test frame but the last. Batch: train_images (Ntr, S, 3, H, W),
    test_images (Nte, S, 3, H, W), train_masks (Ntr, S, H, W), test_masks
    (Nte, S, H, W). The stats: Loss/total and Loss/segm (the same value)."""

    def __init__(self, net, loss_weight: Optional[Dict[str, float]] = None,
                 num_refinement_iter: int = 2):
        self.net = net
        self.loss_weight = loss_weight or {"segm": 100.0}
        self.num_refinement_iter = num_refinement_iter

    def __call__(self, batch: Dict[str, torch.Tensor]):
        masks = self.net(batch["train_images"], batch["test_images"], batch["train_masks"],
                         num_refinement_iter=self.num_refinement_iter)
        loss = self.loss_weight["segm"] * lovasz_seg_loss(masks, batch["test_masks"])
        return loss, {"Loss/total": loss, "Loss/segm": loss}


class RTSActor:
    """RTS's objective: the Lovász hinge of the test frames' fused masks
    (weight 10), plus LBHinge of the classifier's test scores, cut to the
    labels' grid, on the Gaussian labels (weight 10). Batch: train_images,
    test_images, train_masks, test_masks as LWLActor's, train_anno (Ntr, S,
    4), test_label (Nte, S, h, w). The stats: Loss/total, Loss/segm and
    Loss/clf (unweighted)."""

    def __init__(self, net, loss_weight: Optional[Dict[str, float]] = None):
        self.net = net
        self.loss_weight = loss_weight or {"segm": 10.0, "clf": 10.0}

    def __call__(self, batch: Dict[str, torch.Tensor]):
        masks, clf_scores = self.net(batch["train_images"], batch["test_images"],
                                     batch["train_masks"], batch["train_anno"])
        loss_segm = lovasz_seg_loss(masks, batch["test_masks"])
        label = batch["test_label"]
        h, w = label.shape[-2:]
        loss_clf = lbhinge(clf_scores[:, :, 0, :h, :w], label)
        loss = self.loss_weight["segm"] * loss_segm + self.loss_weight["clf"] * loss_clf
        return loss, {"Loss/total": loss, "Loss/segm": loss_segm, "Loss/clf": loss_clf}


def _mask_iou(pred_logits: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean IoU of the masks where the logits are positive (probability
    above 0.5) with the ground truth, (..., H, W) each; a union of 0 counts
    as 1."""
    p = (torch.sigmoid(pred_logits) > 0.5).to(gt.dtype)
    inter = (p * gt).sum((-2, -1))
    union = torch.clamp((p + gt - p * gt).sum((-2, -1)), min=1.0)
    return (inter / union).mean()


class LWLBoxActor:
    """The box-init objective: masks decoded from the train frames' encoded
    boxes, the Lovász hinge on those frames' masks (weight 10). Batch:
    train_images (Ntr, S, 3, H, W), train_anno (Ntr, S, 4), train_masks
    (Ntr, S, H, W). The stats: Loss/total and Stats/acc_box_train
    (_mask_iou)."""

    def __init__(self, net, loss_weight: Optional[Dict[str, float]] = None):
        self.net = net
        self.loss_weight = loss_weight or {"segm_box": 10.0}

    def __call__(self, batch: Dict[str, torch.Tensor]):
        masks = self.net.box_forward(batch["train_images"], batch["train_anno"])
        loss = self.loss_weight["segm_box"] * lovasz_seg_loss(masks, batch["train_masks"])
        return loss, {"Loss/total": loss,
                      "Stats/acc_box_train": _mask_iou(masks.detach(), batch["train_masks"])}
