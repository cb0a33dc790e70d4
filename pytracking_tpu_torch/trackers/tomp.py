"""ToMP tracker: transformer model prediction for classification and box
regression (counterpart of pytracking_tpu/trackers/tomp.py `ToMPParams`,
`ToMPState`, `ToMPTracker`).

Every frame the memorised train frames (M = `sample_memory_size` fixed
slots: the first frame and the latest confident one) and the test frame go
through the filter predictor in one forward that gives the classification
filter (copy 0: every stored slot) and the box-regression filter (copy 1:
the initial frame only); empty slots are masked out of the attention. The
box is the dense LTRB map read at the score peak; a not_found frame keeps
the position and rescales the search area from a ring of recent scales.

The state is fixed-shape tensors on the tracker's device. The memory holds
the *extracted* head features (the feature block is per sample, so
extracting once when a frame is stored equals extracting the whole memory
every frame); its buffers are updated in place at the slot chosen on the
device. `track` synchronises with the host once, to read back the box, the
flag and the peak score in one copy.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from pytracking_tpu_torch.ops import dcf
from pytracking_tpu_torch.ops.patch import sample_patch
from pytracking_tpu_torch.trackers.base import (BaseTracker, StreamLayout, masked_stream_slots_set,
                                                one_stream_step)
from pytracking_tpu_torch.trackers.dimp import (FLAG_HARD_NEG, FLAG_NAMES, FLAG_NORMAL,
                                                FLAG_NOT_FOUND, FLAG_UNCERTAIN,
                                                _get_iounet_box)
from pytracking_tpu_torch.utils.device import ieee_float32


@dataclass(frozen=True)
class ToMPParams:
    """Static tracker configuration: the JAX package's fields and defaults
    (ToMP-50's). `kernel_size`, `train_skipping`, `window_output` and
    `target_inside_ratio` are declared there and read nowhere; they are kept
    so that the parameter modules map one to one."""
    train_feature_size: int = 18
    feature_stride: int = 16
    search_area_scale: float = 5.0
    border_mode: str = "inside_major"
    patch_max_scale_change: Optional[float] = 1.5
    kernel_size: int = 1
    sample_memory_size: int = 2
    learning_rate: float = 0.01
    init_samples_minimum_weight: float = 0.25
    train_skipping: int = 20
    update_classifier: bool = True
    conf_ths: float = 0.9
    output_sigma_factor: float = 1 / 4
    window_output: bool = False
    # advanced localisation
    advanced_localization: bool = True
    target_not_found_threshold: float = 0.25
    uncertain_threshold: float = -float("inf")
    hard_sample_threshold: float = -float("inf")
    distractor_threshold: float = 0.8
    hard_negative_threshold: float = 0.5
    target_neighborhood_scale: float = 2.2
    displacement_scale: float = 0.8
    hard_negative_learning_rate: float = 0.02
    target_inside_ratio: float = 0.2
    search_area_rescaling_at_occlusion: bool = True
    scale_history_size: int = 60

    @property
    def image_sample_size(self) -> int:
        return self.train_feature_size * self.feature_stride


@dataclass
class ToMPState:
    pos: torch.Tensor                # (2,) (y, x)
    target_sz: torch.Tensor          # (2,) (h, w)
    target_scale: torch.Tensor       # ()
    base_target_sz: torch.Tensor     # (2,)
    image_sz: torch.Tensor           # (2,) (H, W)
    min_scale: torch.Tensor          # ()
    max_scale: torch.Tensor          # ()
    sigma: torch.Tensor              # (2,) label sigma in feature cells
    mem_samples: torch.Tensor        # (M, C, h, w) extracted head features
    mem_labels: torch.Tensor         # (M, h, w)
    mem_boxes: torch.Tensor          # (M, 4) xywh in patch coordinates
    mem_weights: torch.Tensor        # (M,)
    num_stored: torch.Tensor         # () int32
    num_init: torch.Tensor           # () int32
    prev_ind: torch.Tensor           # () int32, -1 = none
    scale_history: torch.Tensor      # (scale_history_size,) recent target scales, newest last
    scale_hist_len: torch.Tensor     # () int32
    not_found_counter: torch.Tensor  # () int32
    frame_num: int                   # host count: 1 after initialize
    flag: torch.Tensor               # () int32, the last localisation flag
    max_score: torch.Tensor          # ()


@dataclass
class BatchedToMPState:
    """`ToMPState` of B streams: every per-stream field with a leading
    stream axis, the memory with the stream axis second, (M, B, ...)."""
    pos: torch.Tensor                # (B, 2)
    target_sz: torch.Tensor          # (B, 2)
    target_scale: torch.Tensor       # (B,)
    base_target_sz: torch.Tensor     # (B, 2)
    image_sz: torch.Tensor           # (B, 2)
    min_scale: torch.Tensor          # (B,)
    max_scale: torch.Tensor          # (B,)
    sigma: torch.Tensor              # (B, 2)
    mem_samples: torch.Tensor        # (M, B, C, h, w)
    mem_labels: torch.Tensor         # (M, B, h, w)
    mem_boxes: torch.Tensor          # (M, B, 4)
    mem_weights: torch.Tensor        # (M, B)
    num_stored: torch.Tensor         # (B,) int32
    num_init: torch.Tensor           # (B,) int32
    prev_ind: torch.Tensor           # (B,) int32
    scale_history: torch.Tensor      # (B, scale_history_size)
    scale_hist_len: torch.Tensor     # (B,) int32
    not_found_counter: torch.Tensor  # (B,) int32
    frame_num: int                   # host count, shared by the streams
    flag: torch.Tensor               # (B,) int32
    max_score: torch.Tensor          # (B,)


_LAYOUT = StreamLayout(ToMPState, BatchedToMPState,
                       memory=("mem_samples", "mem_labels", "mem_boxes", "mem_weights"))


class ToMPTracker(BaseTracker):
    """One instance tracks one target in one sequence; the step is written
    over a leading stream axis (`_step_streams`), which the batched server
    runs for B streams and the single tracker for one."""

    _layout = _LAYOUT

    def __init__(self, params: ToMPParams, net, device="cuda"):
        super().__init__(params, device)
        self.net = net.to(self.device).eval()
        # per-frame constants, uploaded once (a host tensor copied to the
        # card mid-frame would synchronise)
        p = params
        ss = p.image_sample_size
        self._support = self._f32([ss, ss])
        self._cell_centres = torch.arange(0, ss, p.feature_stride, dtype=torch.float32,
                                          device=self.device) + p.feature_stride // 2
        self._slots = torch.arange(p.sample_memory_size, device=self.device)
        self._hist_idx = torch.arange(p.scale_history_size, device=self.device)
        n = p.train_feature_size
        self._score_center = self._f32([(n - 1) / 2] * 2)
        self._cell_px = self._support / n                # score cell in sample pixels
        self._iy = torch.arange(n, dtype=torch.float32, device=self.device)[:, None]
        self._ix = torch.arange(n, dtype=torch.float32, device=self.device)[None, :]
        self._debug_outputs = False
        self.state: Optional[ToMPState] = None

    def _f32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=self.device)

    def enable_debug_outputs(self) -> None:
        """Add the frame's score map (h, w) to `track`'s output, as a numpy
        array (a second copy to the host)."""
        self._debug_outputs = True

    # ---------------------------------------------------------------- host API

    @torch.inference_mode()
    @ieee_float32()
    def initialize(self, image, info: Dict[str, Any]) -> dict:
        """image (H, W, 3) RGB; info['init_bbox'] = [x, y, w, h]."""
        im = self._image_tensor(image)
        bbox = self._f32(info["init_bbox"])
        image_sz = self._f32([im.shape[1], im.shape[2]])
        pos, target_sz, target_scale = self._target_geometry(bbox)
        patch, coords = self._crop(im, torch.round(pos), target_scale, image_sz)
        self.state = self._initialize_from_patch(patch, coords, pos, target_sz, target_scale,
                                                 image_sz)
        return {}

    @torch.inference_mode()
    @ieee_float32()
    def track(self, image, info: Optional[dict] = None) -> dict:
        im = self._image_tensor(image)
        state = self.state
        patch, coords = self._crop(im, state.pos, state.target_scale, state.image_sz)
        self.state, out = self._track_from_patch(state, patch, coords)
        host = torch.cat([out["target_bbox"], out["max_score"][None],
                          out["flag"][None].float()]).cpu().numpy()    # the one sync
        flag = FLAG_NAMES[int(host[5])]
        bbox = host[:4].tolist()
        if getattr(self.params, "output_not_found_box", False) and flag == "not_found":
            bbox = [-1, -1, -1, -1]
        result = {"target_bbox": bbox, "object_presence_score": float(host[4]),
                  "max_score": float(host[4]), "flag": flag}
        if self._debug_outputs:
            result["score_map"] = out["score_map"].cpu().numpy()
        return result

    # ---------------------------------------------------------------- geometry

    def _target_geometry(self, bbox):
        """(y, x) centre, (h, w) size and the sample scale of an xywh box."""
        p = self.params
        pos = torch.stack([bbox[1] + (bbox[3] - 1) / 2, bbox[0] + (bbox[2] - 1) / 2])
        target_sz = torch.stack([bbox[3], bbox[2]])
        search_area = torch.prod(target_sz * p.search_area_scale)
        return pos, target_sz, torch.sqrt(search_area) / float(p.image_sample_size)

    def _crop(self, im, pos, target_scale, image_sz):
        """The search patch at `pos` and its extent in the image."""
        p = self.params
        ss = p.image_sample_size
        return sample_patch(im, pos, target_scale * self._support, (ss, ss),
                            mode=p.border_mode, max_scale_change=p.patch_max_scale_change,
                            im_sz=image_sz)

    def _sample_geometry(self, coords):
        """Centre and scale of sampled extents [y0, x0, y1, x1] (..., 4)."""
        sample_pos = 0.5 * (coords[..., :2] + coords[..., 2:])
        sample_scale = torch.sqrt(torch.prod((coords[..., 2:] - coords[..., :2]) / self._support,
                                             -1))
        return sample_pos, sample_scale

    def _label(self, pos, sample_pos, sample_scale, sigma) -> torch.Tensor:
        """Gaussian labels (..., h, w) centred on `pos` (..., 2), offset from
        the grid centre; sample_scale (...), sigma (..., 2)."""
        feat_sz = self.params.train_feature_size
        center = feat_sz * (pos - sample_pos) / (sample_scale[..., None] * self._support)
        labels = dcf.gauss_2d((feat_sz, feat_sz), sigma.reshape(-1, 2), center.reshape(-1, 2))
        return labels.reshape(center.shape[:-1] + labels.shape[-2:])

    def _encode_ltrb(self, boxes: torch.Tensor) -> torch.Tensor:
        """Dense LTRB targets of xywh boxes (..., 4) on the feature grid,
        normalised by the sample size: (..., h, w, 4)."""
        ss = self.params.image_sample_size
        loc = self._cell_centres
        n = loc.shape[0]
        x1 = boxes[..., 0, None, None]
        y1 = boxes[..., 1, None, None]
        x2 = x1 + boxes[..., 2, None, None]
        y2 = y1 + boxes[..., 3, None, None]
        xs = loc[None, :]
        ys = loc[:, None]
        shape = boxes.shape[:-1] + (n, n)
        ltrb = [(xs - x1).expand(shape), (ys - y1).expand(shape), (x2 - xs).expand(shape),
                (y2 - ys).expand(shape)]
        return torch.stack(ltrb, dim=-1) / ss

    # ---------------------------------------------------------------- initialize

    def _initialize_from_patch(self, patch, coords, pos, target_sz, target_scale,
                               image_sz) -> ToMPState:
        p = self.params
        net = self.net
        base_target_sz = target_sz / target_scale
        sample_pos, sample_scale = self._sample_geometry(coords)
        x = net.extract_head_feat(net.extract_backbone(patch[None]))          # (1, C, h, w)
        target_box = _get_iounet_box(pos, target_sz, sample_pos, sample_scale, self._support)
        feat_sz = p.train_feature_size
        sigma = torch.sqrt(torch.prod(feat_sz / self._support * base_target_sz)) \
            * p.output_sigma_factor * torch.ones(2, device=self.device)
        label = self._label(pos, sample_pos, sample_scale, sigma)

        M = p.sample_memory_size
        mem_samples = x.new_zeros((M,) + x.shape[1:])
        mem_samples[0] = x[0]
        mem_labels = label.new_zeros((M,) + label.shape)
        mem_labels[0] = label
        mem_boxes = x.new_zeros((M, 4))
        mem_boxes[0] = target_box
        mem_weights = x.new_zeros((M,))
        mem_weights[0] = 1.0

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)

        return ToMPState(
            pos=pos, target_sz=target_sz, target_scale=target_scale,
            base_target_sz=base_target_sz, image_sz=image_sz,
            min_scale=torch.max(10.0 / base_target_sz),
            max_scale=torch.min(image_sz / base_target_sz), sigma=sigma,
            mem_samples=mem_samples, mem_labels=mem_labels, mem_boxes=mem_boxes,
            mem_weights=mem_weights, num_stored=i32(1), num_init=i32(1), prev_ind=i32(-1),
            scale_history=target_scale.expand(p.scale_history_size).clone(),
            scale_hist_len=i32(1), not_found_counter=i32(0), frame_num=1,
            flag=i32(FLAG_NORMAL), max_score=torch.ones((), device=self.device))

    # ---------------------------------------------------------------- track

    def _track_from_patch(self, state: ToMPState, patch, coords):
        """The step of one stream: `_step_streams` on a batch of one."""
        return one_stream_step(self._layout, self._step_streams, state, patch, coords)

    def _crop_streams(self, state: BatchedToMPState, frames):
        """`_crop` of B streams in one batched crop: the search patches
        (B, 3, s, s) of frames (B, 3, H, W) and their extents (B, 4)."""
        p = self.params
        ss = p.image_sample_size
        return sample_patch(frames, state.pos, state.target_scale[:, None] * self._support,
                            (ss, ss), mode=p.border_mode,
                            max_scale_change=p.patch_max_scale_change, im_sz=state.image_sz)

    def _step_streams(self, state: BatchedToMPState, patch, coords, uniform=None):
        """One frame of B streams from their search patches (B, 3, s, s) and
        the patches' extents (B, 4): (the new state, {'target_bbox' (B, 4),
        'max_score' (B,), 'flag' (B,), 'score_map' (B, h, w)}), all on the
        device; the memory is written in place. ToMP draws nothing
        (`uniform` is unused)."""
        p = self.params
        net = self.net
        ss = p.image_sample_size
        B = patch.shape[0]
        state = dataclasses.replace(state, frame_num=state.frame_num + 1)
        sample_pos, sample_scale = self._sample_geometry(coords)          # (B, 2), (B,)

        # transductive model prediction over each stream's memory: the
        # streams are the predictor's sequence axis, each with its own slot
        # masks
        test_x = net.get_backbone_head_feat(net.extract_backbone(patch))
        test_feat = net.head.extract_head_feat(test_x[None])             # (1, B, C, h, w)
        slot_valid = self._slots[:, None] < state.num_stored             # (M, B)
        gth_mask = self._slots[:, None] < state.num_init                 # slot 0: first frame
        train_ltrb = self._encode_ltrb(state.mem_boxes)                  # (M, B, h, w, 4)
        cls_w, bbreg_w, cls_enc, bbreg_enc = net.head_get_filters_parallel(
            state.mem_samples, test_feat, state.mem_labels, train_ltrb, slot_valid, gth_mask)
        scores = net.head_classify(cls_enc, cls_w)[0]                    # (B, h, w)
        bbox_preds = net.head_bbreg(bbreg_enc, bbreg_w)[0]               # (B, 4, h, w)

        flag, max_score, loc = self._localize_streams(state, scores, sample_pos, sample_scale)

        # direct box regression at each stream's peak, clipped to its image
        cell = loc[:, 0] * bbox_preds.shape[-1] + loc[:, 1]
        lv = bbox_preds.flatten(2).gather(2, cell[:, None, None].expand(B, 4, 1))[..., 0] \
            * float(ss)                                                  # (B, 4)
        xs_c = loc[:, 1].float() * p.feature_stride + p.feature_stride // 2
        ys_c = loc[:, 0].float() * p.feature_stride + p.feature_stride // 2
        ext_x = coords[:, 3] - coords[:, 1]
        ext_y = coords[:, 2] - coords[:, 0]
        x1 = (xs_c - lv[:, 0]) / ss * ext_x + coords[:, 1]
        y1 = (ys_c - lv[:, 1]) / ss * ext_y + coords[:, 0]
        x2 = (xs_c + lv[:, 2]) / ss * ext_x + coords[:, 1]
        y2 = (ys_c + lv[:, 3]) / ss * ext_y + coords[:, 0]
        H, W = state.image_sz[:, 0], state.image_sz[:, 1]
        x1 = torch.minimum(torch.clamp(x1, min=0.0), W - 10.0)
        y1 = torch.minimum(torch.clamp(y1, min=0.0), H - 10.0)
        x2 = torch.minimum(torch.maximum(x2, x1 + 10.0), W)
        y2 = torch.minimum(torch.maximum(y2, y1 + 10.0), H)
        bw, bh = x2 - x1, y2 - y1

        found = flag != FLAG_NOT_FOUND
        new_pos = torch.stack([y1 + bh / 2, x1 + bw / 2], -1)
        new_sz = torch.stack([bh, bw], -1)
        new_scale = torch.sqrt(torch.prod(new_sz, -1) / torch.prod(state.base_target_sz, -1))

        # the scale-history ring and the search-area rescaling at occlusion
        Hn = p.scale_history_size
        hist = torch.where(found[:, None],
                           torch.cat([state.scale_history[:, 1:], new_scale[:, None]], -1),
                           state.scale_history)
        hist_len = torch.where(found, torch.clamp(state.scale_hist_len + 1, max=Hn),
                               state.scale_hist_len)
        nf_counter = torch.where(found, 0, state.not_found_counter + 1).to(torch.int32)
        if p.search_area_rescaling_at_occlusion:
            num_scales = torch.clamp(nf_counter, 2, 30)
            recent = self._hist_idx >= Hn - torch.minimum(num_scales, hist_len)[:, None]
            sel = recent & (hist >= hist[:, -1:])
            resc = torch.where(sel, hist, 0.0).sum(-1) / torch.clamp(sel.sum(-1), min=1)
            tscale = torch.where(found, new_scale, resc)
        else:
            tscale = torch.where(found, new_scale, state.target_scale)
        state = dataclasses.replace(
            state, pos=torch.where(found[:, None], new_pos, state.pos),
            target_sz=torch.where(found[:, None], new_sz, state.target_sz), target_scale=tscale,
            scale_history=hist, scale_hist_len=hist_len, not_found_counter=nf_counter)

        # memory update: each stream's extracted head feature, masked per stream
        do_update = ((flag != FLAG_NOT_FOUND) & (flag != FLAG_UNCERTAIN)
                     & (max_score > p.conf_ths) & p.update_classifier)
        lr = torch.where(flag == FLAG_HARD_NEG, p.hard_negative_learning_rate, p.learning_rate)
        target_box = _get_iounet_box(state.pos, state.target_sz, sample_pos,
                                     sample_scale[:, None], self._support)
        label = self._label(state.pos, sample_pos, sample_scale, state.sigma)
        state = self._update_memory_streams(state, test_feat[0], label, target_box, lr,
                                            do_update)

        state = dataclasses.replace(state, flag=flag, max_score=max_score)
        bbox = torch.cat([state.pos.flip(-1) - (state.target_sz.flip(-1) - 1) / 2,
                          state.target_sz.flip(-1)], -1)
        return state, {"target_bbox": bbox, "max_score": max_score, "flag": flag,
                       "score_map": scores}

    # ---------------------------------------------------------------- localisation

    def _localize_streams(self, state: BatchedToMPState, scores, sample_pos, sample_scale):
        """Localisation per stream on the (B, h, w) score maps (a 1x1 filter:
        the feature grid) with the distractor analysis when
        `advanced_localization`: (flag (B,) int32, max score (B,), the
        chosen peak's (row, col) (B, 2) int64)."""
        p = self.params
        h, w = scores.shape[-2:]
        B = scores.shape[0]
        max_score1, max_disp1 = dcf.max2d(scores)
        if not p.advanced_localization:
            return (torch.zeros((B,), dtype=torch.int32, device=self.device), max_score1,
                    max_disp1)
        disp_to_img = self._cell_px * sample_scale[:, None]                  # (B, 2)
        d1 = max_disp1.float()
        target_disp1 = d1 - self._score_center
        target_neigh_sz = p.target_neighborhood_scale * \
            (state.target_sz / sample_scale[:, None]) / self._cell_px
        in_neigh = ((torch.abs(self._iy - d1[:, 0, None, None])
                     <= target_neigh_sz[:, 0, None, None] / 2 + 0.5)
                    & (torch.abs(self._ix - d1[:, 1, None, None])
                       <= target_neigh_sz[:, 1, None, None] / 2 + 0.5))
        max_score2, max_disp2 = dcf.max2d(torch.where(in_neigh, 0.0, scores))
        target_disp2 = max_disp2.float() - self._score_center

        prev_target_vec = (state.pos - sample_pos) / disp_to_img
        disp_norm1 = torch.sqrt(torch.sum((target_disp1 - prev_target_vec) ** 2, -1))
        disp_norm2 = torch.sqrt(torch.sum((target_disp2 - prev_target_vec) ** 2, -1))
        disp_threshold = p.displacement_scale * math.sqrt(h * w) / 2

        distractor = max_score2 > p.distractor_threshold * max_score1
        hn1 = distractor & (disp_norm2 > disp_threshold) & (disp_norm1 < disp_threshold)
        hn2 = distractor & (disp_norm2 < disp_threshold) & (disp_norm1 > disp_threshold)
        uncertain_both = distractor & ~hn1 & ~hn2
        hard_neg2 = (~distractor & (max_score2 > p.hard_negative_threshold * max_score1)
                     & (max_score2 > p.target_not_found_threshold))

        flag = torch.zeros((B,), dtype=torch.int32, device=self.device)
        flag = torch.where(hard_neg2, FLAG_HARD_NEG, flag)
        flag = torch.where(uncertain_both, FLAG_UNCERTAIN, flag)
        flag = torch.where(hn2, FLAG_HARD_NEG, flag)
        loc = torch.where(hn2[:, None], max_disp2, max_disp1)
        flag = torch.where(hn1, FLAG_HARD_NEG, flag)
        # the score thresholds dominate, the not-found one most
        flag = torch.where(max_score1 < p.hard_sample_threshold, FLAG_HARD_NEG, flag)
        flag = torch.where(max_score1 < p.uncertain_threshold, FLAG_UNCERTAIN, flag)
        not_found = max_score1 < p.target_not_found_threshold
        flag = torch.where(not_found, FLAG_NOT_FOUND, flag)
        loc = torch.where(not_found[:, None], max_disp1, loc)
        return flag, max_score1, loc

    # ---------------------------------------------------------------- memory

    def _update_memory_streams(self, state: BatchedToMPState, sample, label, target_box, lr,
                               do_update) -> BatchedToMPState:
        """Weighted-replacement update of each stream's M slots, masked by
        `do_update` (B,): the new sample (B, C, h, w), label (B, h, w) and
        box (B, 4) fill the stream's next empty slot, else replace its
        lightest one after the initial ones (the first on ties); the B
        slots are written by one indexed write in place."""
        p = self.params
        M = p.sample_memory_size
        sw = state.mem_weights                                               # (M, B)
        num_init = state.num_init
        num_stored = state.num_stored
        init_w = p.init_samples_minimum_weight
        idx = self._slots[:, None]

        s_ind = num_init if init_w > 0 else 0
        r_ind_full = torch.argmin(torch.where(idx >= s_ind, sw, math.inf), dim=0)
        r_ind = torch.where(num_stored < M, num_stored.long(), r_ind_full)     # (B,)

        prev = state.prev_ind
        sw_new = torch.where(prev < 0, sw / (1 - lr), sw)
        prev_w = sw.gather(0, torch.clamp(prev, min=0).long()[None])[0]
        new_w = torch.where(prev < 0, lr, prev_w / (1 - lr))
        sw_new = torch.where(idx == r_ind, new_w, sw_new)
        sw_new = sw_new / sw_new.sum(0)
        if init_w > 0:
            init_mask = idx < num_init
            init_sum = torch.where(init_mask, sw_new, 0.0).sum(0)
            rest_sum = torch.where(~init_mask, sw_new, 0.0).sum(0)
            sw_adj = torch.where(init_mask, init_w / torch.clamp(num_init, min=1),
                                 sw_new / (init_w + rest_sum))
            sw_new = torch.where(init_sum < init_w, sw_adj, sw_new)

        masked_stream_slots_set(((state.mem_samples, sample), (state.mem_labels, label),
                                 (state.mem_boxes, target_box)), r_ind, do_update)
        return dataclasses.replace(
            state,
            mem_weights=torch.where(do_update, sw_new, state.mem_weights),
            num_stored=torch.where(do_update, torch.clamp(num_stored + 1, max=M), num_stored),
            prev_ind=torch.where(do_update, r_ind.to(torch.int32), state.prev_ind))


def get_tracker_class():
    return ToMPTracker
