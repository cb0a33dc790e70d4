"""TaMOs tracker: transformer multi-object tracking with a shared model
predictor (counterpart of pytracking_tpu/trackers/tamos.py).

The whole frame (aspect preserved, replicate-padded) is resampled to the
sample size; one forward of the GOT filter predictor emits every object's
filters; per-object localisation and direct LTRB box regression run on the
high-res FPN level. The object axis is a batch dimension of K fixed slots
with a validity mask. The state is fixed-shape tensors on the tracker's
device; the memory buffers are updated in place, at the slot chosen on the
device, and `track` synchronises with the host once, to read back the
boxes and scores.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pytracking_tpu_torch.ops import dcf
from pytracking_tpu_torch.ops.patch import sample_patch
from pytracking_tpu_torch.trackers.base import BaseTracker, masked_slot_set, take
from pytracking_tpu_torch.utils.device import ieee_float32

FLAG_NORMAL, FLAG_NOT_FOUND, FLAG_HARD_NEG, FLAG_UNCERTAIN = 0, 1, 2, 3
FLAG_NAMES = ["normal", "not_found", "hard_negative", "uncertain"]


@dataclass(frozen=True)
class TaMOsParams:
    train_feature_size: Tuple[int, int] = (24, 36)
    feature_stride: int = 16
    sample_memory_size: int = 2
    learning_rate: float = 0.01
    hard_negative_learning_rate: float = 0.02
    init_samples_minimum_weight: float = 0.25
    update_classifier: bool = True
    conf_ths: float = 0.85
    normalize_scores: bool = True
    output_sigma_factor: float = 1 / 4
    num_tokens: int = 10
    target_not_found_threshold: float = 0.25
    distractor_threshold: float = 0.8
    hard_negative_threshold: float = 0.5
    target_neighborhood_scale: float = 1.5
    displacement_scale: float = 0.8
    uncertain_threshold: float = -float("inf")
    hard_sample_threshold: float = -float("inf")

    @property
    def image_sample_size(self) -> Tuple[int, int]:
        return (self.train_feature_size[0] * self.feature_stride,
                self.train_feature_size[1] * self.feature_stride)


@dataclass
class TaMOsState:
    pos: torch.Tensor            # (K, 2) (y, x) per object, image coords
    pos_prev: torch.Tensor       # (K, 2) positions before the last found frame
    target_sz: torch.Tensor      # (K, 2)
    obj_valid: torch.Tensor      # (K,) bool
    image_sz: torch.Tensor       # (2,)
    sigma: torch.Tensor          # (K, 2) label sigmas (feature cells)
    mem_samples: torch.Tensor    # (M, C, h, w) head features
    mem_labels: torch.Tensor     # (M, K, h, w)
    mem_boxes: torch.Tensor      # (M, K, 4) [x, y, w, h] in sample coords
    mem_weights: torch.Tensor    # (M,)
    num_stored: torch.Tensor     # () int32
    prev_ind: torch.Tensor       # () int32
    frame_num: torch.Tensor      # () int32
    flag: torch.Tensor           # (K,) int32
    max_score: torch.Tensor      # (K,)


class TaMOsTracker(BaseTracker):
    multiobj_mode = "default"        # natively multi-object

    def __init__(self, params: TaMOsParams, net, device="cuda"):
        super().__init__(params, device)
        self.net = net.to(self.device).eval()
        # per-frame constants, uploaded once (a host tensor copied to the
        # card mid-frame would synchronise)
        Hs, Ws = params.image_sample_size
        h, w = params.train_feature_size
        self._sample_hw = self._f32([Hs, Ws])
        self._label_offset = self._f32([(h - 1) / 2, (w - 1) / 2])
        self._ltrb_scale = self._f32([Ws, Hs, Ws, Hs])
        self.state: Optional[TaMOsState] = None
        self.id_map: Dict[int, str] = {}
        self.mot_dataset = False

    def _f32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=self.device)

    # ---------------------------------------------------------------- host API

    @torch.inference_mode()
    @ieee_float32()
    def initialize(self, image, info: Dict[str, Any]) -> dict:
        K = self.params.num_tokens
        im = self._image_tensor(image)
        if "init_object_ids" in info or isinstance(info.get("init_bbox"), dict):
            self.mot_dataset = True
            bboxes_dict = info["init_bbox"]
            ext_ids = list(bboxes_dict.keys())
        else:
            self.mot_dataset = False
            bboxes_dict = {"1": info["init_bbox"]}
            ext_ids = ["1"]
        self.id_map = {i: oid for i, oid in enumerate(ext_ids)}

        boxes = np.zeros((K, 4), np.float32)
        valid = np.zeros((K,), bool)
        for i, oid in enumerate(ext_ids[:K]):
            boxes[i] = np.asarray(bboxes_dict[oid], np.float32)
            valid[i] = True

        image_sz = self._f32([im.shape[1], im.shape[2]])
        frame, sfac = self._whole_frame_sample(im, image_sz)
        self.state = self._initialize_from_patch(
            frame, sfac, torch.from_numpy(boxes).to(self.device),
            torch.from_numpy(valid).to(self.device), image_sz)
        return {}

    @torch.inference_mode()
    @ieee_float32()
    def track(self, image, info: Optional[dict] = None) -> dict:
        im = self._image_tensor(image)
        frame, sfac = self._whole_frame_sample(im, self.state.image_sz)
        self.state, out = self._track_from_patch(self.state, frame, sfac)
        host = torch.cat([out["target_bbox"], out["max_score"][:, None]], dim=1).cpu().numpy()
        boxes, scores = host[:, :4], host[:, 4]
        out_boxes = OrderedDict()
        out_scores = OrderedDict()
        for slot, oid in self.id_map.items():
            out_boxes[oid] = boxes[slot].tolist()
            out_scores[oid] = float(scores[slot])
        if not self.mot_dataset:
            result = {"target_bbox": out_boxes["1"],
                      "object_presence_score": out_scores["1"]}
        else:
            result = {"target_bbox": out_boxes, "object_presence_score": out_scores}
        return result

    # ---------------------------------------------------------------- impl

    def _whole_frame_sample(self, im: torch.Tensor, image_sz: torch.Tensor):
        """Resize the whole frame with one scale factor (aspect preserved) and
        replicate-pad to the sample size. Returns (frame (3, Hs, Ws), scale)."""
        Hs, Ws = self.params.image_sample_size
        H_im, W_im = image_sz[0], image_sz[1]
        s = torch.where(H_im / W_im <= float(Hs) / Ws, Ws / W_im, Hs / H_im)
        extent = self._sample_hw / s
        pos = extent / 2.0 - 0.5
        frame, _ = sample_patch(im, pos, extent, (Hs, Ws))
        return frame, s

    def _labels(self, pos, sfac, sigma, valid) -> torch.Tensor:
        """Per-object Gaussian labels (K, h, w) at `pos`, zero for empty slots."""
        p = self.params
        centers = (pos * sfac) / p.feature_stride - self._label_offset
        labels = dcf.gauss_2d(p.train_feature_size, sigma, centers)
        return torch.where(valid[:, None, None], labels, 0.0)

    def _encode_ltrb(self, boxes: torch.Tensor) -> torch.Tensor:
        """(M, K, 4) [x, y, w, h] sample-coord boxes -> per-cell LTRB maps
        (M, K, h, w, 4) normalised by the sample size; zero for empty boxes."""
        p = self.params
        Hs, Ws = p.image_sample_size
        h, w = p.train_feature_size
        stride = p.feature_stride
        xs = torch.arange(w, dtype=torch.float32, device=self.device) * stride + stride // 2
        ys = torch.arange(h, dtype=torch.float32, device=self.device) * stride + stride // 2
        x1, y1 = boxes[..., 0], boxes[..., 1]
        x2, y2 = boxes[..., 0] + boxes[..., 2], boxes[..., 1] + boxes[..., 3]
        shape = boxes.shape[:2] + (h, w)
        l = ((xs[None, None, None, :] - x1[..., None, None]) / Ws).expand(shape)
        t = ((ys[None, None, :, None] - y1[..., None, None]) / Hs).expand(shape)
        r = ((x2[..., None, None] - xs[None, None, None, :]) / Ws).expand(shape)
        b = ((y2[..., None, None] - ys[None, None, :, None]) / Hs).expand(shape)
        ltrb = torch.stack([l, t, r, b], dim=-1)
        valid = (boxes[..., 2] > 0) & (boxes[..., 3] > 0)
        return torch.where(valid[..., None, None, None], ltrb, 0.0)

    def _initialize_from_patch(self, frame, sfac, boxes, valid, image_sz) -> TaMOsState:
        p = self.params
        K = p.num_tokens
        M = p.sample_memory_size
        backbone_feat = self.net.extract_backbone(frame[None])
        x_head = self.net.extract_head_feat(backbone_feat)[0]          # (C, h, w)

        pos = torch.stack([boxes[:, 1] + (boxes[:, 3] - 1) / 2,
                           boxes[:, 0] + (boxes[:, 2] - 1) / 2], dim=-1)
        target_sz = torch.stack([boxes[:, 3], boxes[:, 2]], dim=-1)
        sz_sample = target_sz * sfac
        sigma = torch.sqrt(torch.prod(sz_sample / p.feature_stride, dim=-1, keepdim=True)) \
            * p.output_sigma_factor * torch.ones((1, 2), device=self.device)
        labels = self._labels(pos, sfac, sigma, valid)

        mem_samples = x_head.new_zeros((M,) + x_head.shape)
        mem_samples[0] = x_head
        mem_labels = labels.new_zeros((M,) + labels.shape)
        mem_labels[0] = labels
        mem_boxes = boxes.new_zeros((M, K, 4))
        mem_boxes[0] = torch.where(valid[:, None], boxes * sfac, 0.0)
        mem_weights = boxes.new_zeros((M,))
        mem_weights[0] = 1.0

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)

        return TaMOsState(pos=pos, pos_prev=pos.clone(), target_sz=target_sz,
                          obj_valid=valid, image_sz=image_sz, sigma=sigma,
                          mem_samples=mem_samples, mem_labels=mem_labels,
                          mem_boxes=mem_boxes, mem_weights=mem_weights,
                          num_stored=i32(1), prev_ind=i32(-1), frame_num=i32(1),
                          flag=torch.zeros((K,), dtype=torch.int32, device=self.device),
                          max_score=torch.ones((K,), device=self.device))

    def _track_from_patch(self, state: TaMOsState, frame, sfac):
        p = self.params
        Hs, Ws = p.image_sample_size
        K = p.num_tokens
        M = p.sample_memory_size
        net = self.net
        state = dataclasses.replace(state, frame_num=state.frame_num + 1)

        backbone_feat = net.extract_backbone(frame[None])
        test_feat = net.extract_head_feat(backbone_feat)[None]          # (1, 1, C, h, w)
        slots = torch.arange(M, device=self.device)
        frame_mask = slots < state.num_stored
        gth_mask = slots == 0
        train_ltrb = self._encode_ltrb(state.mem_boxes)[:, None]        # (M, 1, K, h, w, 4)
        cls_w, bb_w, cls_enc, bb_enc = net.predict_filters_parallel(
            state.mem_samples[:, None], test_feat, state.mem_labels[:, None], train_ltrb,
            frame_mask, gth_mask)
        feat2 = net.run_fpn(bb_enc, backbone_feat)["feat2"]
        h2, w2 = feat2.shape[-2], feat2.shape[-1]
        scores = net.classify_trafo(cls_enc, cls_w, (h2, w2))[0, 0]     # (K, h2, w2)
        ltrb = net.bbreg(feat2, bb_w)[0, 0]                             # (K, 4, h2, w2)
        if p.normalize_scores:
            scores = torch.sigmoid(scores)

        stride2 = Hs // h2
        cell_px = stride2 / sfac
        flags, loc, max_scores = self._localize(scores, state.pos, state.pos_prev,
                                                state.target_sz, cell_px)
        kk = torch.arange(K, device=self.device)
        lv = ltrb[kk, :, loc[:, 0], loc[:, 1]] * self._ltrb_scale
        xc = loc[:, 1].float() * stride2 + stride2 / 2
        yc = loc[:, 0].float() * stride2 + stride2 / 2
        H_im, W_im = state.image_sz[0], state.image_sz[1]
        x1 = torch.clamp((xc - lv[:, 0]) / sfac, min=0.0)
        x1 = torch.minimum(x1, W_im - 10.0)
        y1 = torch.minimum(torch.clamp((yc - lv[:, 1]) / sfac, min=0.0), H_im - 10.0)
        x2 = torch.minimum(torch.maximum((xc + lv[:, 2]) / sfac, x1 + 10.0), W_im)
        y2 = torch.minimum(torch.maximum((yc + lv[:, 3]) / sfac, y1 + 10.0), H_im)
        found = flags != FLAG_NOT_FOUND
        new_pos = torch.where(found[:, None],
                              torch.stack([(y1 + y2) / 2, (x1 + x2) / 2], dim=-1), state.pos)
        new_sz = torch.where(found[:, None], torch.stack([y2 - y1, x2 - x1], dim=-1),
                             state.target_sz)

        valid = state.obj_valid
        moved = valid & found
        state = dataclasses.replace(
            state,
            pos_prev=torch.where(moved[:, None], state.pos, state.pos_prev),
            pos=torch.where(valid[:, None], new_pos, state.pos),
            target_sz=torch.where(valid[:, None], new_sz, state.target_sz),
            flag=flags, max_score=max_scores)

        # memory update only when every valid object is confidently found;
        # the learning rate follows the last valid object's flag
        per_obj_ok = (~valid) | ((flags != FLAG_NOT_FOUND) & (flags != FLAG_UNCERTAIN)
                                 & (max_scores > p.conf_ths))
        do_update = per_obj_ok.all() & p.update_classifier
        last_obj = (K - 1) - torch.argmax(valid.flip(0).to(torch.int32))
        lr = torch.where(take(flags, last_obj) == FLAG_HARD_NEG,
                         p.hard_negative_learning_rate, p.learning_rate)
        labels = self._labels(state.pos, sfac, state.sigma, valid)
        cur_boxes = torch.cat([state.pos.flip(-1) - (state.target_sz.flip(-1) - 1) / 2,
                               state.target_sz.flip(-1)], dim=-1)
        sample_boxes = torch.where(valid[:, None], cur_boxes * sfac, 0.0)
        state = self._update_memory(state, test_feat[0, 0], labels, sample_boxes, lr,
                                    do_update)

        return state, {"target_bbox": cur_boxes, "max_score": max_scores, "flag": flags}

    def _localize(self, score, pos, pos_prev, sz, cell_px):
        """Advanced localisation of the K objects at once (ATOM-style):
        neighbourhood-masked second peak, displacement analysis, the four
        flags. score (K, h2, w2). Returns (flags (K,) int32, loc (K, 2),
        max score (K,))."""
        p = self.params
        h2, w2 = score.shape[-2], score.shape[-1]
        score_center = pos / cell_px

        max1, disp1 = dcf.max2d(score)
        disp1f = disp1.float()
        target_disp1 = disp1f - score_center
        neigh = p.target_neighborhood_scale * sz / cell_px
        top = torch.clamp(torch.round(disp1f[:, 0] - neigh[:, 0] / 2), 0, h2)
        bottom = torch.clamp(torch.round(disp1f[:, 0] + neigh[:, 0] / 2 + 1), 0, h2)
        left = torch.clamp(torch.round(disp1f[:, 1] - neigh[:, 1] / 2), 0, w2)
        right = torch.clamp(torch.round(disp1f[:, 1] + neigh[:, 1] / 2 + 1), 0, w2)
        iy = torch.arange(h2, dtype=torch.float32, device=score.device)[None, :, None]
        ix = torch.arange(w2, dtype=torch.float32, device=score.device)[None, None, :]
        in_neigh = ((iy >= top[:, None, None]) & (iy < bottom[:, None, None])
                    & (ix >= left[:, None, None]) & (ix < right[:, None, None]))
        max2, disp2 = dcf.max2d(torch.where(in_neigh, 0.0, score))
        target_disp2 = disp2.float() - score_center

        prev_target_vec = (pos - pos_prev) / cell_px
        disp_norm1 = torch.sqrt(torch.sum((target_disp1 - prev_target_vec) ** 2, dim=-1))
        disp_norm2 = torch.sqrt(torch.sum((target_disp2 - prev_target_vec) ** 2, dim=-1))
        disp_threshold = p.displacement_scale * math.sqrt(h2 * w2) / 2

        distractor = max2 > p.distractor_threshold * max1
        hn1 = distractor & (disp_norm2 > disp_threshold) & (disp_norm1 < disp_threshold)
        hn2 = distractor & (disp_norm2 < disp_threshold) & (disp_norm1 > disp_threshold)
        uncertain_both = distractor & ~hn1 & ~hn2
        hard_neg_plain = (~distractor & (max2 > p.hard_negative_threshold * max1)
                          & (max2 > p.target_not_found_threshold))

        flag = torch.full_like(max1, FLAG_NORMAL, dtype=torch.int32)
        loc = disp1
        flag = torch.where(hard_neg_plain, FLAG_HARD_NEG, flag)
        flag = torch.where(uncertain_both, FLAG_UNCERTAIN, flag)
        flag = torch.where(hn2, FLAG_HARD_NEG, flag)
        loc = torch.where(hn2[:, None], disp2, loc)
        flag = torch.where(hn1, FLAG_HARD_NEG, flag)
        loc = torch.where(hn1[:, None], disp1, loc)
        # score thresholds dominate; an uncertain score also drops the
        # distractor peak chosen above
        hard = max1 < p.hard_sample_threshold
        flag = torch.where(hard, FLAG_HARD_NEG, flag)
        loc = torch.where(hard[:, None], disp1, loc)
        uncertain = max1 < p.uncertain_threshold
        flag = torch.where(uncertain, FLAG_UNCERTAIN, flag)
        loc = torch.where(uncertain[:, None], disp1, loc)
        not_found = max1 < p.target_not_found_threshold
        flag = torch.where(not_found, FLAG_NOT_FOUND, flag)
        loc = torch.where(not_found[:, None], disp1, loc)
        return flag, loc, max1

    def _update_memory(self, state: TaMOsState, sample, labels, boxes, lr,
                       do_update) -> TaMOsState:
        p = self.params
        M = p.sample_memory_size
        sw = state.mem_weights
        num_stored = state.num_stored
        init_w = p.init_samples_minimum_weight

        idx = torch.arange(M, device=self.device)
        r_ind_full = torch.argmin(torch.where(idx >= 1, sw, math.inf))  # slot 0 = init
        r_ind = torch.where(num_stored < M, num_stored.long(), r_ind_full)

        prev = state.prev_ind
        sw_new = torch.where(prev < 0, sw / (1 - lr), sw)
        new_w = torch.where(prev < 0, lr, take(sw, torch.clamp(prev, min=0)) / (1 - lr))
        sw_new = torch.where(idx == r_ind, new_w, sw_new)
        sw_new = sw_new / sw_new.sum()
        if init_w and init_w > 0:
            init_mask = idx < 1
            init_sum = torch.where(init_mask, sw_new, 0.0).sum()
            rest_sum = torch.where(~init_mask, sw_new, 0.0).sum()
            sw_adj = torch.where(init_mask, init_w, sw_new / (init_w + rest_sum))
            sw_new = torch.where(init_sum < init_w, sw_adj, sw_new)

        masked_slot_set(state.mem_samples, r_ind, sample, do_update)
        masked_slot_set(state.mem_labels, r_ind, labels, do_update)
        masked_slot_set(state.mem_boxes, r_ind, boxes, do_update)
        return dataclasses.replace(
            state,
            mem_weights=torch.where(do_update, sw_new, state.mem_weights),
            num_stored=torch.where(do_update, torch.clamp(num_stored + 1, max=M),
                                   num_stored),
            prev_ind=torch.where(do_update, r_ind.to(torch.int32), state.prev_ind))


def get_tracker_class():
    return TaMOsTracker
