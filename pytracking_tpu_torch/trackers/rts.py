"""RTS tracker: LWL's mask branch with a DiMP-style instance classifier
fused into the decoder, and the STA box-to-mask start (counterpart of
pytracking_tpu/trackers/rts.py `RTSParams`, `RTSState`, `RTSTracker`).

A frame: as LWL, the previous mask updates the mask memory and places the
search region, but only while the target is not lost, and a lost target's
search area is rescaled from the history of found scales; the classifier
scores the crop, its score map is encoded and fused with the mask
encoding; the classifier's peak drives the lost / re-found counter.

Host and device: the frame's one readback carries the mask, scores, box,
the lost counter and whether the target was found. The counter chooses on
the host the next frame's mask-memory update and refit and whether that
frame rescales; the classifier refit (found, every `clf_train_skipping`
frames) is enqueued after the readback, ahead of the next frame's
classification, as in `DiMPTracker`. The classifier memory update is masked
on the device by the found flag. The mask is emitted whatever the lost
state.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from pytracking_tpu_torch.ops import augmentation as aug
from pytracking_tpu_torch.ops import dcf
from pytracking_tpu_torch.ops.patch import sample_patch
from pytracking_tpu_torch.trackers.base import masked_slot_set, take
from pytracking_tpu_torch.trackers.dimp import _get_iounet_box
from pytracking_tpu_torch.trackers.lwl import LWLParams, LWLState, LWLTracker


@dataclass(frozen=True)
class RTSParams(LWLParams):
    """RTS-50's fields on LWL's, with the JAX package's defaults."""
    search_area_scale: float = 6.0
    max_scale_change: Tuple[float, float] = (0.8, 1.2)
    train_skipping: int = 20
    # classifier branch
    clf_sample_memory_size: int = 50
    clf_learning_rate: float = 0.01
    clf_train_skipping: int = 20
    update_classifier: bool = True
    clf_net_opt_iter: int = 10
    clf_net_opt_update_iter: int = 2
    clf_output_sigma_factor: float = 0.25
    clf_target_not_found_threshold: float = 0.30
    clf_target_not_found_threshold_too_small: float = 0.50
    clf_init_samples_minimum_weight: float = 0.25
    clf_filter_size: int = 4
    # image-space augmentations of the classifier's first frame
    clf_use_augmentation: bool = True
    clf_augmentation: tuple = (("fliplr", True),
                               ("blur", ((3, 1), (1, 3), (2, 2))))
    scale_history_size: int = 30
    # STA box-init
    sta_image_sample_size: Tuple[int, int] = (30 * 16, 52 * 16)
    sta_search_area_scale: float = 4.0


@dataclass
class RTSState(LWLState):
    """LWL's state for one object (O = 1) and the classifier branch's."""
    clf_filter: torch.Tensor = None       # (1, 1, C, fs, fs)
    clf_mem_samples: torch.Tensor = None  # (M, C, hc, wc)
    clf_mem_boxes: torch.Tensor = None    # (M, 4) xywh in crop pixels
    clf_mem_labels: torch.Tensor = None   # (M, hc + 1, wc + 1) Gaussian regression labels
    clf_sigma: torch.Tensor = None        # (2,) label sigma, fixed at init
    clf_feat_sz: torch.Tensor = None      # (2,) the classifier's feature grid (hc, wc)
    clf_mem_weights: torch.Tensor = None  # (M,)
    clf_num_stored: torch.Tensor = None   # () int64
    clf_prev_ind: torch.Tensor = None     # () int64, -1 = none
    scale_history: torch.Tensor = None    # (30,) oldest first
    scale_hist_len: torch.Tensor = None   # () int64
    lost_counter: torch.Tensor = None     # () int64
    lost_frames: int = 0                  # its host copy from the last readback
    clf_max_score: torch.Tensor = None    # ()


class RTSTracker(LWLTracker):
    """One object. With no init mask and an STA net (`sta_net`, or
    `sta_factory() -> net` built on first use) the first mask comes from
    the box."""

    def __init__(self, params: RTSParams, net, device="cuda", sta_net=None, sta_factory=None):
        super().__init__(params, net, device)
        self.sta_net = None if sta_net is None else \
            sta_net.to(self.device).eval().requires_grad_(False)
        self._sta_factory = sta_factory
        self._hist_idx = torch.arange(params.scale_history_size, device=self.device)
        self._clf_mem_idx = torch.arange(params.clf_sample_memory_size, device=self.device)

    # ------------------------------------------------------------ STA box-init

    def _mask_from_box(self, im: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
        if self.sta_net is None and self._sta_factory is not None:
            self.sta_net = self._sta_factory().to(self.device).eval().requires_grad_(False)
        if self.sta_net is None:
            return super()._mask_from_box(im, bbox)
        return self._sta_predict_mask(im, bbox)

    def _sta_crop(self, im: torch.Tensor, bbox: torch.Tensor):
        """STA's input for a box: the search region `sta_search_area_scale`
        times the box, (3, Hs, Ws), the box in crop pixels (x, y, w, h) and
        the crop's image coordinates."""
        p = self.params
        Hs, Ws = p.sta_image_sample_size
        support = self._f32([float(Hs), float(Ws)])
        pos, target_sz, _ = self._geometry(bbox[None], p.sta_search_area_scale)
        pos, target_sz = pos[0], target_sz[0]
        target_scale = torch.sqrt(torch.prod(target_sz * p.sta_search_area_scale)) / \
            torch.sqrt(torch.prod(support))
        patch, coords = sample_patch(im, pos, target_scale * support, (Hs, Ws), mode="replicate")
        sample_pos = 0.5 * (coords[:2] + coords[2:] - 1)
        sample_scale = torch.sqrt(torch.prod((coords[2:] - coords[:2]) / support))
        box_center = (pos - sample_pos) / sample_scale + (support - 1) / 2
        box_sz = target_sz / sample_scale
        bb_crop = torch.cat([(box_center - (box_sz - 1) / 2).flip(-1), box_sz.flip(-1)])
        return patch, bb_crop, coords

    def _sta_predict_mask(self, im: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
        """Box -> (H, W) first-frame mask through STA: decode STA's refined
        mask of the box's crop, paste its logits (-100 outside the crop and
        outside the box) and threshold at 0."""
        patch, bb_crop, coords = self._sta_crop(im, bbox)
        _, refined = self.sta_net(patch[None, None], bb_crop[None, None])
        H, W = im.shape[-2:]
        vals, inside = self._paste(refined[0], coords[None], H, W)
        scores = torch.where(inside, vals, -100.0)[0]
        xs = torch.arange(W, dtype=torch.float32, device=self.device)
        ys = torch.arange(H, dtype=torch.float32, device=self.device)
        x0, y0 = torch.floor(bbox[0]), torch.floor(bbox[1])
        inbox = ((xs >= x0) & (xs < x0 + torch.floor(bbox[2])))[None, :] & \
            ((ys >= y0) & (ys < y0 + torch.floor(bbox[3])))[:, None]
        return (torch.where(inbox, scores, -100.0) > 0.0).float()

    # ---------------------------------------------------------------- initialize

    def _clf_label(self, feat_sz, feat_sz_t, sigma, pos, sample_pos, sample_scale
                   ) -> torch.Tensor:
        """Gaussian regression label on the classifier's score grid of
        `feat_sz` (ints; `feat_sz_t` the same on the device), centred on the
        target (feature cells from the crop centre), end-padded for the even
        filter: (hc + 1, wc + 1)."""
        ksz_even = (self.params.clf_filter_size + 1) % 2
        center = feat_sz_t * (pos - sample_pos) / (sample_scale * self._support) \
            + 0.5 * ksz_even
        return dcf.gauss_2d(feat_sz, sigma, center, (ksz_even, ksz_even))[0]

    def _initialize(self, im, bbox, init_mask) -> RTSState:
        state = super()._initialize(im, bbox, init_mask)
        p = self.params
        Hs, Ws = p.image_sample_size
        pos, target_sz, target_scale = state.pos[0], state.target_sz[0], state.target_scale[0]
        patch, coords = sample_patch(im, torch.round(pos), target_scale * self._support,
                                     (Hs, Ws), mode=p.border_mode, im_sz=state.image_sz)
        sample_pos = 0.5 * (coords[:2] + coords[2:])
        sample_scale = torch.sqrt(torch.prod((coords[2:] - coords[:2]) / self._support))
        augs = dict(p.clf_augmentation) if p.clf_use_augmentation else {}
        transforms = aug.build_transforms(augs, (Hs, Ws), 0.0)
        im_patches = aug.apply_all(patch, transforms, (Hs, Ws))            # (T, 3, Hs, Ws)
        T = im_patches.shape[0]
        clf_xs = self.net.extract_classification_feat(self.net.extract_backbone(im_patches))
        h, w = clf_xs.shape[-2:]
        clf_feat_sz = self._f32([float(h), float(w)])
        target_box = _get_iounet_box(pos, target_sz, sample_pos, sample_scale, self._support)
        flip_box = torch.cat([float(Ws) - target_box[:1] - target_box[2:3], target_box[1:]])
        boxes = torch.stack([flip_box if t.kind == "fliplr" else target_box for t in transforms])

        base = state.base_target_sz[0]
        clf_sigma = torch.sqrt(torch.prod(self._f32([h / float(Hs), w / float(Ws)]) * base)) \
            * p.clf_output_sigma_factor * torch.ones(2, device=self.device)
        init_label = self._clf_label((h, w), clf_feat_sz, clf_sigma, pos, sample_pos,
                                     sample_scale)
        labels = init_label.expand((T, 1) + init_label.shape)
        clf_filter = self.net.clf_get_filter(clf_xs[:, None], boxes[:, None], labels,
                                             num_iter=p.clf_net_opt_iter)

        M = p.clf_sample_memory_size
        Tm = min(T, M)     # a memory smaller than the augmentations keeps the first M
        clf_mem = clf_xs.new_zeros((M,) + clf_xs.shape[1:])
        clf_mem[:Tm] = clf_xs[:Tm]
        clf_boxes = clf_xs.new_zeros((M, 4))
        clf_boxes[:Tm] = boxes[:Tm]
        clf_labels = clf_xs.new_zeros((M,) + init_label.shape)
        clf_labels[:Tm] = init_label
        clf_w = clf_xs.new_zeros((M,))
        clf_w[:Tm] = 1.0 / T

        def i64(v):
            return torch.tensor(v, dtype=torch.long, device=self.device)

        return RTSState(
            **{f.name: getattr(state, f.name) for f in dataclasses.fields(LWLState)},
            clf_filter=clf_filter, clf_mem_samples=clf_mem, clf_mem_boxes=clf_boxes,
            clf_mem_labels=clf_labels, clf_sigma=clf_sigma, clf_feat_sz=clf_feat_sz,
            clf_mem_weights=clf_w,
            clf_num_stored=i64(Tm), clf_prev_ind=i64(-1),
            scale_history=target_scale.expand(p.scale_history_size).clone(),
            scale_hist_len=i64(1), lost_counter=i64(0), lost_frames=0,
            clf_max_score=torch.ones((), device=self.device))

    # ---------------------------------------------------------------- track

    def _memory_update_allowed(self, state: RTSState) -> bool:
        return state.frame_num > 2 and state.lost_frames == 0

    def _new_geometry(self, state: RTSState, prev_prob: torch.Tensor) -> RTSState:
        """LWL's placement; a lost target keeps its position, and its scale
        becomes the mean of the newest min(max(lost, 2), 30) history scales
        at least as large as the newest one."""
        kept_pos = state.pos
        state = super()._new_geometry(state, prev_prob)
        if state.lost_frames == 0:
            return state
        Hn = self.params.scale_history_size
        num_scales = torch.clamp(state.lost_counter, 2, 30)
        hist = state.scale_history
        recent = self._hist_idx >= Hn - torch.minimum(num_scales, state.scale_hist_len)
        sel = recent & (hist >= hist[-1])
        resc = torch.where(sel, hist, 0.0).sum() / torch.clamp(sel.sum(), min=1)
        return dataclasses.replace(state, pos=kept_pos, target_scale=resc[None],
                                   target_sz=state.base_target_sz * resc)

    def _segment(self, state: RTSState, backbone_feat, test_x):
        clf_x = self.net.extract_classification_feat(backbone_feat)        # (1, C, hc, wc)
        clf_scores = self.net.clf_classify(state.clf_filter, clf_x)       # (1, 1, hs, ws)
        seg_crop, _ = self.net.segment_target_with_clf(
            state.target_filter, test_x[None], backbone_feat, clf_scores,
            self.params.image_sample_size)
        return seg_crop, {"clf_x": clf_x, "clf_max": clf_scores.max()}

    def _finish_step(self, state: RTSState, out, backbone_feat, coords):
        """The lost / re-found counter, the classifier memory update (masked
        by found) and the scale history."""
        p = self.params
        clf_x, clf_max = out.pop("clf_x"), out["clf_max"]
        lost = state.lost_counter > 0
        found = clf_max >= p.clf_target_not_found_threshold
        refound = found & lost & (clf_max >= p.clf_target_not_found_threshold_too_small)
        now_found = torch.where(lost, refound, found)
        if p.update_classifier:
            c = coords[0]
            sample_pos = 0.5 * (c[:2] + c[2:])
            sample_scale = torch.sqrt(torch.prod((c[2:] - c[:2]) / self._support))
            pos, target_sz = state.pos[0], state.target_sz[0]
            target_box = _get_iounet_box(pos, target_sz, sample_pos, sample_scale, self._support)
            label = self._clf_label(clf_x.shape[-2:], state.clf_feat_sz, state.clf_sigma, pos,
                                    sample_pos, sample_scale)
            state = self._clf_update_memory(state, clf_x[0], target_box, label,
                                            p.clf_learning_rate, now_found)
        hist = torch.where(now_found, torch.cat([state.scale_history[1:], state.target_scale]),
                           state.scale_history)
        hist_len = torch.where(now_found, torch.clamp(state.scale_hist_len + 1,
                                                      max=p.scale_history_size),
                               state.scale_hist_len)
        lost_counter = torch.where(now_found, 0, state.lost_counter + 1)
        state = dataclasses.replace(state, lost_counter=lost_counter, clf_max_score=clf_max,
                                    scale_history=hist, scale_hist_len=hist_len)
        out.update(now_found=now_found, lost_counter=lost_counter)
        return state, out

    def _extra_readback(self, out) -> list:
        return [out["lost_counter"].float()[None], out["now_found"].float()[None],
                out["clf_max"][None]]

    def _after_readback(self, extra: np.ndarray, result: dict) -> None:
        """Keeps the lost counter's host copy and enqueues the classifier
        refit of a found frame every `clf_train_skipping` frames."""
        p = self.params
        lost_frames, now_found, clf_max = int(extra[0]), bool(extra[1]), float(extra[2])
        self.state = dataclasses.replace(self.state, lost_frames=lost_frames)
        result.update(lost_counter=lost_frames, found=now_found, clf_max_score=clf_max)
        if p.update_classifier and now_found and \
                (self.state.frame_num - 1) % p.clf_train_skipping == 0:
            self._clf_refit()

    def _clf_refit(self) -> None:
        st = self.state
        new_filter = self.net.classifier.filter_optimizer(
            st.clf_filter, st.clf_mem_samples[:, None], st.clf_mem_boxes[:, None],
            train_label=st.clf_mem_labels[:, None], sample_weight=st.clf_mem_weights[:, None],
            num_iter=self.params.clf_net_opt_update_iter)
        self.state = dataclasses.replace(st, clf_filter=new_filter)

    def _clf_update_memory(self, state: RTSState, sample, target_box, label, lr,
                           do_update) -> RTSState:
        """The classifier's weighted-replacement memory, masked by
        `do_update`; the first two slots count as the initial ones, as in
        the JAX tracker."""
        p = self.params
        M = p.clf_sample_memory_size
        sw = state.clf_mem_weights
        num_init = 2
        num_stored = state.clf_num_stored
        init_w = p.clf_init_samples_minimum_weight
        idx = self._clf_mem_idx
        s_ind = num_init if init_w > 0 else 0
        r_ind_full = torch.argmin(torch.where(idx >= s_ind, sw, math.inf))
        r_ind = torch.where(num_stored < M, num_stored, r_ind_full)
        prev = state.clf_prev_ind
        sw_new = torch.where(prev < 0, sw / (1 - lr), sw)
        new_w = torch.where(prev < 0, lr, take(sw, torch.clamp(prev, min=0)) / (1 - lr))
        sw_new = torch.where(idx == r_ind, new_w, sw_new)
        sw_new = sw_new / sw_new.sum()
        if init_w > 0:
            init_mask = idx < num_init
            init_sum = torch.where(init_mask, sw_new, 0.0).sum()
            rest_sum = torch.where(~init_mask, sw_new, 0.0).sum()
            sw_adj = torch.where(init_mask, init_w / num_init, sw_new / (init_w + rest_sum))
            sw_new = torch.where(init_sum < init_w, sw_adj, sw_new)
        masked_slot_set(state.clf_mem_samples, r_ind, sample, do_update)
        masked_slot_set(state.clf_mem_boxes, r_ind, target_box, do_update)
        masked_slot_set(state.clf_mem_labels, r_ind, label, do_update)
        return dataclasses.replace(
            state, clf_mem_weights=torch.where(do_update, sw_new, sw),
            clf_num_stored=torch.where(do_update, torch.clamp(num_stored + 1, max=M), num_stored),
            clf_prev_ind=torch.where(do_update, r_ind, prev))


def get_tracker_class():
    return RTSTracker
