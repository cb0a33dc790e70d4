"""Actors: the training loss on top of a net's forward (counterpart of
pytracking_tpu/training/actors/tracking.py `make_dimp_actor`,
`make_atom_actor`, `make_kldimp_actor`, `make_tomp_actor`,
`make_tamos_actor`, `make_lwl_actor`, `make_rts_actor`, `make_lwl_box_actor`,
`make_kys_actor`, `make_tcm_actor`).

An actor is called on a batch on the device and returns (loss, stats),
both device tensors; the train step differentiates the loss with autograd
and reads the stats back once. Batch layout, frame-major: train_images
(Ntrain, S, 3, H, W) and test_images (Ntest, S, 3, H, W) in 0-255,
train_anno (Ntrain, S, 4), test_proposals (Ntest, S, P, 4), proposal_iou
(Ntest, S, P), test_label (Ntest, S, h, w); PrDiMP's processing gives
proposal_density and gt_density (Ntest, S, P) and test_label_density
(Ntest, S, h, w) instead of proposal_iou and test_label. ToMP's,
TaMOs's, KYS's, the matcher's and the segmentation actors' are in their
docstrings.

The trainer puts the step's dropout seed in the batch as 'rng_seed' (a
host int); the actors of nets with dropout seed their own generator on the
net's device with it, so a resumed run draws the same masks.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from pytracking_tpu_torch.models.kys.cost_volume import cost_volume_abs
from pytracking_tpu_torch.models.layers.blocks import eval_mode, frozen_running_stats
from pytracking_tpu_torch.models.loss.bbr_loss import giou_loss
from pytracking_tpu_torch.models.loss.kl_regression import kl_regression, kl_regression_grid
from pytracking_tpu_torch.models.loss.segmentation import lovasz_seg_loss
from pytracking_tpu_torch.models.loss.target_candidate_matching import (
    matching_metrics, target_candidate_matching_loss)
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


def _reseeded(generator: Optional[torch.Generator], device, seed: int) -> torch.Generator:
    """`generator`, or a new one where it is None or on another device,
    seeded with `seed`. Seeding a device generator is a host-side state
    change: no synchronisation."""
    device = torch.device(device)
    if generator is None or generator.device != device:
        generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator


class _DropoutActor:
    """An actor whose net draws dropout masks in train mode: a generator on
    the net's device, seeded per step with the batch's 'rng_seed' (0
    without one)."""

    def __init__(self, net):
        self.net = net
        self._generator: Optional[torch.Generator] = None

    def generator(self, batch: Dict[str, torch.Tensor]) -> torch.Generator:
        self._generator = _reseeded(self._generator, next(self.net.parameters()).device,
                                    int(batch.get("rng_seed", 0)))
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
    4), test_label (Nte, S, h, w), and optionally clf_train_label (Ntr, S,
    h', w'): the classifier's train labels, which the net otherwise makes
    itself (rts_net.fallback_train_label). The stats: Loss/total,
    Loss/segm and Loss/clf (unweighted)."""

    def __init__(self, net, loss_weight: Optional[Dict[str, float]] = None):
        self.net = net
        self.loss_weight = loss_weight or {"segm": 10.0, "clf": 10.0}

    def __call__(self, batch: Dict[str, torch.Tensor]):
        masks, clf_scores = self.net(batch["train_images"], batch["test_images"],
                                     batch["train_masks"], batch["train_anno"],
                                     train_label=batch.get("clf_train_label"))
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


def _masked_bce(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """KYS's is-target loss: the logits pred (S, 1, h, w) against target >
    0.05, summed over the sequences where mask (S, 1, 1, 1) is 1, over
    their cell count (at least 1)."""
    t = (target > 0.05).to(pred.dtype)
    loss = -(t * F.logsigmoid(pred) + (1 - t) * F.logsigmoid(-pred))
    count = mask.sum() * (loss[0].numel() / mask[0].numel())
    return (loss * mask).sum() / torch.clamp(count, min=1.0)


class KYSActor:
    """KYS's objective. The appearance model is frozen and runs without
    autograd: the backbone on the train frames, then on the test frames,
    with the batch's BatchNorm statistics in train mode and every running
    statistic left as it is (the JAX actor drops the new ones), the filter
    learnt on the train frames, and the scores of the test frames cut to the
    labels' grid. Frames 1 and later have their scores jittered
    (`jitter`, a DiMPScoreJittering, with a generator seeded by the sum of
    the batch's jitter_seed). The predictor, its BatchNorms in eval mode as
    the JAX actor calls it, seeds its state from frame 0's label at frame 1
    and propagates it over frames 2 to T-1 on cost volumes of the
    classification features. The loss: test_clf 0.01 and test_clf_orig 0.01
    (LBHinge of the fused and the unthresholded response), is_target 0.1
    and is_target_after_prop 0.1 (BCE of the state's target map before and
    after the propagation), each the mean over frames 1 to T-1 with the
    absent test frames masked out, and dimp_clf 1e-4 (LBHinge of the
    jittered scores, no gradient). Batch: train_images (Ntr, S, 3, H, W),
    train_anno (Ntr, S, 4), test_images (T, S, 3, H, W), test_label (T, S,
    h, w), test_valid_image (T, S), or (1, S, T) as the loader collates the
    sampler's per-sample vectors, and jitter_seed (S,) on the host. The
    stats: Loss/total, Loss/test_clf, Loss/dimp_clf, Loss/is_target,
    Loss/is_target_after_prop and ClfTrain/test_acc (frames 2 to T-1). Only
    the predictor may train: a parameter outside it that requires a
    gradient raises ValueError. `generator_device` places the jitter's
    draws (the net's device by default)."""

    def __init__(self, net, loss_weight: Optional[Dict[str, float]] = None, jitter=None,
                 generator_device=None):
        self.net = net
        self.loss_weight = loss_weight or {"test_clf": 0.01, "dimp_clf": 0.0001,
                                           "is_target": 0.1, "is_target_after_prop": 0.1,
                                           "test_clf_orig": 0.01}
        self.jitter = jitter
        self.generator_device = generator_device
        self._generator: Optional[torch.Generator] = None

    def generator(self, batch: Dict[str, torch.Tensor]) -> torch.Generator:
        """The jitter's generator, seeded with the sum of the batch's
        jitter_seed (0 without one). The seeds stay on the host
        (trainer.HOST_KEYS), so seeding reads no device value."""
        device = self.generator_device if self.generator_device is not None \
            else next(self.net.parameters()).device
        seed = batch.get("jitter_seed")
        self._generator = _reseeded(self._generator, device,
                                    0 if seed is None else int(seed.sum()))
        return self._generator

    def __call__(self, batch: Dict[str, torch.Tensor]):
        net, w = self.net, self.loss_weight
        trained = [n for n, p in net.named_parameters()
                   if p.requires_grad and not n.startswith("predictor.")]
        if trained and torch.is_grad_enabled():
            raise ValueError(f"KYSActor trains the predictor alone: {trained[:3]} require grad")
        tr_im, te_im = batch["train_images"], batch["test_images"]
        n_tr, S = tr_im.shape[:2]
        T = te_im.shape[0]
        valid = torch.ones(T, S, device=te_im.device)
        if "test_valid_image" in batch:
            valid = batch["test_valid_image"].to(torch.float32)
            if valid.dim() == 3:
                # the loader's collation of the per-sample vectors: (1, S, T)
                valid = valid[0].t()
        labels = batch["test_label"][:, :, None]                   # (T, S, 1, h, w)
        h, wd = labels.shape[-2:]

        with torch.no_grad(), frozen_running_stats(net):
            tr_clf = net.extract_classification_feat(net.extract_backbone(tr_im.flatten(0, 1)))
            filt = net.classifier.get_filter(tr_clf.reshape((n_tr, S) + tr_clf.shape[1:]),
                                             batch["train_anno"])
            te_clf = net.extract_classification_feat(net.extract_backbone(te_im.flatten(0, 1)))
            motion = te_clf.reshape((T, S) + te_clf.shape[1:])
            # an even filter gives a score grid one cell larger: cut to the labels
            scores = net.classifier.classify(filt, motion)[..., :h, :wd]
            motion = motion[..., :h, :wd]
            if self.jitter is not None:
                scores = torch.cat([scores[:1], self.jitter(scores[1:], labels[1:],
                                                            self.generator(batch))])

        def cost_volume(t):
            return cost_volume_abs(motion[t], motion[t - 1], net.max_displacement,
                                   kernel_size=net.cv_kernel_size)

        def mask(t):
            return valid[t][:, None, None, None]

        with eval_mode(net.predictor):
            fused, state, aux = net.predictor(cost_volume(1), None, scores[1],
                                              init_label=labels[0], aux=True)
            m1 = mask(1)
            first = {"test_clf": lbhinge(fused * m1, labels[1] * m1),
                     "test_clf_orig": lbhinge(aux["fused_score_orig"] * m1, labels[1] * m1),
                     "is_target": _masked_bce(aux["is_target"], labels[0], m1),
                     "is_target_after_prop": _masked_bce(aux["is_target_after_prop"],
                                                         labels[1], m1)}
            rest = {k: [] for k in first}
            acc = []
            for t in range(2, T):
                fused, state, aux = net.predictor(cost_volume(t), state, scores[t], aux=True)
                m_cur, m_prev = mask(t), mask(t - 1)
                rest["test_clf"].append(lbhinge(fused * m_cur, labels[t] * m_cur))
                rest["test_clf_orig"].append(lbhinge(aux["fused_score_orig"] * m_cur,
                                                     labels[t] * m_cur))
                rest["is_target"].append(_masked_bce(aux["is_target"], labels[t - 1], m_prev))
                rest["is_target_after_prop"].append(
                    _masked_bce(aux["is_target_after_prop"], labels[t], m_cur))
                acc.append(tracking_classification_accuracy(fused[:, 0], labels[t, :, 0]))

        # the JAX actor's fold: the first step's term and the mean of the rest
        n_rest = max(T - 2, 0)
        comb = {k: (v + torch.stack(rest[k]).mean() * n_rest) / max(T - 1, 1) if n_rest else v
                for k, v in first.items()}
        vm = valid[1:, :, None, None, None]
        dimp_clf = lbhinge(scores[1:] * vm, labels[1:] * vm)
        loss = sum(w.get(k, 0.0) * v for k, v in comb.items()) + w.get("dimp_clf", 0.0) * dimp_clf
        test_acc = torch.stack(acc).mean() if acc else torch.zeros((), device=fused.device)
        return loss, {"Loss/total": loss, "Loss/test_clf": comb["test_clf"],
                      "Loss/dimp_clf": dimp_clf, "Loss/is_target": comb["is_target"],
                      "Loss/is_target_after_prop": comb["is_target_after_prop"],
                      "ClfTrain/test_acc": test_acc}


class TCMActor:
    """KeepTrack's candidate-matching objective: the balanced assignment NLL
    of the Sinkhorn matrix against the ground-truth matches
    (target_candidate_matching_loss), and the match recall and precision of
    the predicted matches (each candidate of frame 1 matched to its most
    likely candidate of frame 0, or to the dustbin where the dustbin is more
    likely), all on the device. Batch: img0 / img1 (S, 3, H, W) in 0-255,
    tsm_coords0/1 (S, K, 2) cells, img_coords0/1 (S, K, 2) image (x, y),
    scores0/1 (S, K), gt_assignment (S, K, K), gt_matches0/1 (S, K). The
    stats, under the JAX names: Loss/total, Loss/nll_pos, Loss/nll_neg,
    Loss/num_matchable, Loss/num_unmatchable, Loss/sinkhorn_norm,
    Loss/bin_score, match_recall and match_precision."""

    def __init__(self, net, nll_balancing: float = 0.5):
        self.net = net
        self.nll_balancing = nll_balancing

    def __call__(self, batch: Dict[str, torch.Tensor]):
        preds = self.net(batch["img0"], batch["img1"], batch["tsm_coords0"],
                         batch["tsm_coords1"], batch["img_coords0"], batch["img_coords1"],
                         batch["scores0"], batch["scores1"])
        la = preds["log_assignment"]
        losses = target_candidate_matching_loss(la, batch["gt_assignment"],
                                                batch["gt_matches0"], batch["gt_matches1"],
                                                self.net.matcher.bin_score,
                                                nll_balancing=self.nll_balancing)
        inner = la[:, :-1, :-1]
        matches1 = inner.argmax(dim=1)
        matches1 = torch.where(la[:, -1, :-1] > inner.amax(dim=1), -1, matches1)
        metrics = matching_metrics(matches1, batch["gt_matches1"])
        stats = {"Loss/total": losses["total"], "Loss/nll_pos": losses["nll_pos"],
                 "Loss/nll_neg": losses["nll_neg"], "Loss/num_matchable": losses["num_matchable"],
                 "Loss/num_unmatchable": losses["num_unmatchable"],
                 "Loss/sinkhorn_norm": losses["sinkhorn_norm"],
                 "Loss/bin_score": losses["bin_score"], **metrics}
        return losses["total"], stats
