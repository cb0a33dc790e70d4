"""LWL tracker: video object segmentation with a few-shot target model
(counterpart of pytracking_tpu/trackers/lwl.py `LWLParams`, `LWLState`,
`LWLTracker`, `LWLMultiObjectTracker`).

A frame: the previous frame's probabilities, cropped at the previous
search region, go into the 32-slot sample memory; the memory's masks are
re-encoded and the target model refit; the previous mask's centre of mass
and spread place the new search region; the backbone, target model and
decoder segment the crop, and the crop's logits are pasted into the image
(two matrix products over the resampling weights of `ops/patch.py`, -100
outside the crop).

The step is written over a leading object axis O: every per-object tensor
of `LWLState` carries it, and the target model's sequence axis is the
object axis. `LWLTracker` runs O = 1; `LWLMultiObjectTracker` runs all
objects of a sequence in one step and merges their scores on the device.

Host and device: the memory update and the refit depend only on the frame
count, which the host keeps, so they are chosen on the host and never
masked on the device. `track` reads back once per frame (mask, scores and
box in one copy). The previous frame's probabilities stay on the device:
in single-object mode they are `state.seg_raw`, which the step replaces
with a new tensor after its last read, never writes in place.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pytracking_tpu_torch.ops.patch import _resample_weights, sample_patch
from pytracking_tpu_torch.trackers.base import BaseTracker
from pytracking_tpu_torch.utils.device import ieee_float32


@dataclass(frozen=True)
class LWLParams:
    """Static configuration: the JAX package's fields and defaults (the
    lwl_ytvos operating point). `train_sample_interval` is declared there
    and read nowhere; it is kept so that the fields map one to one."""
    image_sample_size: Tuple[int, int] = (30 * 16, 52 * 16)
    search_area_scale: float = 5.0
    border_mode: str = "inside_major"
    patch_max_scale_change: Optional[float] = None
    feature_stride: int = 16
    kernel_size: int = 3
    sample_memory_size: int = 32
    learning_rate: float = 0.1
    init_samples_minimum_weight: float = 0.25
    train_skipping: int = 1
    train_sample_interval: int = 1
    update_target_model: bool = True
    net_opt_iter: int = 20
    net_opt_update_iter: int = 3
    seg_to_bb_mode: str = "var"
    seg_to_bb_sz_factor: float = 4.0
    min_mask_area: float = 100.0
    max_scale_change: Tuple[float, float] = (0.95, 1.1)


@dataclass
class LWLState:
    pos: torch.Tensor              # (O, 2) (y, x)
    target_sz: torch.Tensor        # (O, 2) (h, w)
    target_scale: torch.Tensor     # (O,)
    base_target_sz: torch.Tensor   # (O, 2)
    image_sz: torch.Tensor         # (2,) (H, W)
    prev_pos: torch.Tensor         # (O, 2) the previous frame's search-region centre
    prev_scale: torch.Tensor       # (O,)
    prev_test_x: torch.Tensor      # (O, C, h, w) the previous frame's target-model features
    target_filter: torch.Tensor    # (O, K, C, fs, fs)
    mem_samples: torch.Tensor      # (M, O, C, h, w)
    mem_masks: torch.Tensor        # (M, O, Hs, Ws) crop-resolution soft masks
    mem_weights: torch.Tensor      # (O, M), 0 = empty slot
    num_stored: int                # host count, equal for every object
    num_init: int
    prev_ind: torch.Tensor         # (O,) int64, -1 = none
    frame_num: int                 # host count: 1 after initialize
    seg_raw: torch.Tensor          # (O, H, W) the last frame's probabilities

    def select(self, o: int) -> "LWLState":
        """Object o's part as a one-object state (copies): every tensor but
        `image_sz` has the object axis, first or, in the memory, second."""
        def part(name):
            v = getattr(self, name)
            if name in ("mem_samples", "mem_masks"):
                return v[:, o:o + 1].clone()
            return v[o:o + 1].clone()

        return dataclasses.replace(self, **{
            f.name: part(f.name) for f in dataclasses.fields(LWLState)
            if f.name != "image_sz" and isinstance(getattr(self, f.name), torch.Tensor)})


class LWLTracker(BaseTracker):
    """One instance tracks one object (O = 1). With `object_ids` in the
    init info the outputs follow the JAX tracker's multi-object convention
    (raw logits out, the harness's merged probabilities in through
    `previous_output`); without, the tracker feeds itself its own
    probabilities."""

    def __init__(self, params: LWLParams, net, device="cuda"):
        super().__init__(params, device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        Hs, Ws = params.image_sample_size
        self._support = self._f32([float(Hs), float(Ws)])
        self._mem_idx = torch.arange(params.sample_memory_size, device=self.device)
        self.state: Optional[LWLState] = None
        self.object_id = None

    def _f32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=self.device)

    # ---------------------------------------------------------------- host API

    @torch.no_grad()
    @ieee_float32()
    def initialize(self, image, info: Dict[str, Any]) -> dict:
        """image (H, W, 3) RGB; info['init_bbox'] = [x, y, w, h] and
        info['init_mask'] (H, W) in {0, 1}, or no mask with a box-init net."""
        self.object_id = (info.get("object_ids") or [None])[0]
        im = self._image_tensor(image)
        bbox = self._f32(info["init_bbox"])[None]
        mask = info.get("init_mask")
        if mask is None:
            mask = self._mask_from_box(im, bbox[0])
        else:
            mask = torch.as_tensor(np.asarray(mask, np.float32)).to(self.device)
        self.state = self._initialize(im, bbox, mask[None])
        mask_np = self.state.seg_raw[0].cpu().numpy()
        raw = mask_np if self.object_id is None else (mask_np - 0.5) * 200.0
        return {"segmentation": (mask_np > 0.5).astype(np.uint8), "segmentation_raw": raw}

    @torch.no_grad()
    @ieee_float32()
    def track(self, image, info: Optional[dict] = None) -> dict:
        """With `object_ids` given at init and info['previous_output']
        carrying a dict of probabilities, this object's entry is the previous
        mask; else the tracker's own (`state.seg_raw`, on the device)."""
        im = self._image_tensor(image)
        prev = ((info or {}).get("previous_output") or {}).get("segmentation_raw")
        if self.object_id is not None and isinstance(prev, dict):
            prev_prob = self._image_tensor(np.asarray(prev[self.object_id], np.float32)[..., None])
        else:
            prev_prob = self.state.seg_raw
        self.state, out = self._step(self.state, im, prev_prob)
        raw = out["segmentation_raw"][0]
        seg_out = torch.sigmoid(raw) if self.object_id is None else raw
        host = self._readback([seg_out, out["target_bbox"][0]] + self._extra_readback(out),
                              out["segmentation"][0])
        H, W = raw.shape
        result = {"target_bbox": host["floats"][H * W:H * W + 4].tolist(),
                  "segmentation": host["bytes"].reshape(H, W),
                  "segmentation_raw": host["floats"][:H * W].reshape(H, W)}
        self._after_readback(host["floats"][H * W + 4:], result)
        return result

    def _extra_readback(self, out) -> list:
        """Further float tensors for the frame's one readback (none in LWL)."""
        return []

    def _after_readback(self, extra: np.ndarray, result: dict) -> None:
        """Host work after the frame's readback (none in LWL)."""

    def _readback(self, floats, mask: torch.Tensor) -> Dict[str, np.ndarray]:
        """One device-to-host copy of float32 tensors and a uint8 map: the
        frame's one synchronisation."""
        f = torch.cat([t.reshape(-1).float() for t in floats])
        buf = torch.cat([f.view(torch.uint8), mask.reshape(-1)]).cpu().numpy()
        n = f.numel() * 4
        return {"floats": buf[:n].view(np.float32).copy(), "bytes": buf[n:].copy()}

    # ---------------------------------------------------------------- geometry

    def _geometry(self, bbox: torch.Tensor, search_area_scale: float):
        """(O, 4) xywh boxes -> (y, x) centres, (h, w) sizes (O, 2) and the
        crop scales (O,) of a search area `search_area_scale` times the box."""
        pos = torch.stack([bbox[:, 1] + (bbox[:, 3] - 1) / 2,
                           bbox[:, 0] + (bbox[:, 2] - 1) / 2], dim=-1)
        target_sz = torch.stack([bbox[:, 3], bbox[:, 2]], dim=-1)
        search_area = torch.prod(target_sz * search_area_scale, dim=-1)
        return pos, target_sz, torch.sqrt(search_area) / torch.sqrt(torch.prod(self._support))

    def _crop(self, im, pos, scale, image_sz, mode=None, **kw):
        """The (O, C, Hs, Ws) crops of extent scale x the sample size about
        pos, and their extents (O, 4)."""
        p = self.params
        return sample_patch(im, pos, scale[:, None] * self._support, p.image_sample_size,
                            mode=mode or p.border_mode, max_scale_change=p.patch_max_scale_change,
                            im_sz=image_sz, **kw)

    def _paste(self, seg_crop: torch.Tensor, coords: torch.Tensor, H: int, W: int):
        """Crop logits (O, Hs, Ws) into the image (O, H, W): each image pixel
        resamples the crop at its back-projected coordinate; returns the
        values and the mask of pixels inside the crop."""
        Hs, Ws = seg_crop.shape[-2:]
        tl = coords[:, :2]
        sz = coords[:, 2:] - coords[:, :2]
        cy = (torch.arange(H, dtype=torch.float32, device=self.device) - tl[:, 0:1]) * Hs \
            / sz[:, 0:1] - 0.5
        cx = (torch.arange(W, dtype=torch.float32, device=self.device) - tl[:, 1:2]) * Ws \
            / sz[:, 1:2] - 0.5
        ry = _resample_weights(cy, Hs, 1.0)                      # (O, H, Hs)
        rx = _resample_weights(cx, Ws, 1.0)                      # (O, W, Ws)
        vals = torch.matmul(torch.matmul(ry, seg_crop), rx.transpose(-1, -2))
        inside = ((cy >= -0.5) & (cy <= Hs - 0.5))[:, :, None] & \
            ((cx >= -0.5) & (cx <= Ws - 0.5))[:, None, :]
        return vals, inside

    def _seg_to_state(self, state: LWLState, prob_im: torch.Tensor):
        """Centre of mass and 4x the standard deviation of the (O, H, W)
        probabilities; the previous position and size where a mask's area
        is below `min_mask_area`."""
        p = self.params
        H, W = prob_im.shape[-2:]
        s = prob_im.sum(dim=(-2, -1))[:, None]
        ys = torch.arange(H, dtype=torch.float32, device=self.device)
        xs = torch.arange(W, dtype=torch.float32, device=self.device)
        py = prob_im.sum(dim=-1)
        px = prob_im.sum(dim=-2)
        den = torch.clamp(s, min=1e-6)
        e_y = torch.sum(py * ys, dim=-1, keepdim=True) / den
        e_x = torch.sum(px * xs, dim=-1, keepdim=True) / den
        e_h = torch.sum(py * (ys - e_y) ** 2, dim=-1, keepdim=True) / den
        e_w = torch.sum(px * (xs - e_x) ** 2, dim=-1, keepdim=True) / den
        k = p.seg_to_bb_sz_factor
        pos = torch.cat([e_y, e_x], dim=-1)
        sz = torch.cat([torch.sqrt(e_h) * k, torch.sqrt(e_w) * k], dim=-1)
        ok = s >= p.min_mask_area
        return torch.where(ok, pos, state.pos), torch.where(ok, sz, state.target_sz)

    # ---------------------------------------------------------------- initialize

    def _mask_from_box(self, im: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
        """First-frame (H, W) mask from a box through the box label encoder
        and the decoder: the decoded crop's probabilities pasted into the
        image, thresholded at 0.5, 0 outside the crop."""
        if not hasattr(self.net, "box_label_encoder"):
            raise ValueError("no init mask given and the net has no box label encoder")
        p = self.params
        Hs, Ws = p.image_sample_size
        pos, _, target_scale = self._geometry(bbox[None], p.search_area_scale)
        image_sz = self._f32([im.shape[-2], im.shape[-1]])
        patch, coords = self._crop(im, torch.round(pos), target_scale, image_sz)
        backbone_feat = self.net.extract_backbone(patch)
        feat_tm = self.net.extract_target_model_features(backbone_feat)     # (1, C, h, w)
        tl = coords[0, :2]
        scale_yx = self._support / (coords[0, 2:] - tl)
        bb_crop = torch.stack([(bbox[0] - tl[1]) * scale_yx[1], (bbox[1] - tl[0]) * scale_yx[0],
                               bbox[2] * scale_yx[1], bbox[3] * scale_yx[0]])
        logits, _ = self.net.segment_target_from_box(bb_crop[None, None], feat_tm[:, None],
                                                     backbone_feat, (Hs, Ws))
        vals, inside = self._paste(logits, coords, im.shape[-2], im.shape[-1])
        return ((torch.sigmoid(vals) > 0.5) & inside).float()[0]

    def _initialize(self, im: torch.Tensor, bbox: torch.Tensor, init_mask: torch.Tensor
                    ) -> LWLState:
        """bbox (O, 4), init_mask (O, H, W) -> the state of O objects."""
        p = self.params
        O = bbox.shape[0]
        image_sz = self._f32([im.shape[-2], im.shape[-1]])
        pos, target_sz, target_scale = self._geometry(bbox, p.search_area_scale)
        init_pos = torch.round(pos)
        patch, _ = self._crop(im, init_pos, target_scale, image_sz)
        mask_patch, _ = self._crop(init_mask[:, None], init_pos, target_scale, image_sz,
                                   is_mask=True)
        mask_patch = mask_patch[:, 0]                                        # (O, Hs, Ws)

        backbone_feat = self.net.extract_backbone(patch)
        x = self.net.extract_target_model_features(backbone_feat)          # (O, C, h, w)
        label, sw = self.net.label_encode(mask_patch[None], x[None])
        target_filter = self.net.tm_get_filter(x[None], label, sw, p.net_opt_iter)

        M = p.sample_memory_size
        mem_samples = x.new_zeros((M,) + x.shape)
        mem_samples[0] = x
        mem_masks = x.new_zeros((M,) + mask_patch.shape)
        mem_masks[0] = mask_patch
        mem_weights = x.new_zeros((O, M))
        mem_weights[:, 0] = 1.0
        return LWLState(
            pos=pos, target_sz=target_sz, target_scale=target_scale,
            base_target_sz=target_sz / target_scale[:, None], image_sz=image_sz,
            prev_pos=init_pos, prev_scale=target_scale, prev_test_x=x,
            target_filter=target_filter, mem_samples=mem_samples, mem_masks=mem_masks,
            mem_weights=mem_weights, num_stored=1, num_init=1,
            prev_ind=torch.full((O,), -1, dtype=torch.long, device=self.device),
            frame_num=1, seg_raw=init_mask)

    # ---------------------------------------------------------------- track

    def _memory_update_allowed(self, state: LWLState) -> bool:
        """Whether this frame stores the previous frame (frame 3 on)."""
        return state.frame_num > 2

    def _update_target_model(self, state: LWLState, prev_prob: torch.Tensor) -> LWLState:
        """The previous frame's probabilities into the memory, then the
        refit every `train_skipping` frames; both chosen on the host."""
        p = self.params
        if not (p.update_target_model and self._memory_update_allowed(state)):
            return state
        prev_crop, _ = self._crop(prev_prob[:, None], state.prev_pos, state.prev_scale,
                                  state.image_sz)
        state = self._update_memory(state, state.prev_test_x, prev_crop[:, 0], p.learning_rate)
        if (state.frame_num - 1) % p.train_skipping == 0:
            state = self._run_model_update(state)
        return state

    def _new_geometry(self, state: LWLState, prev_prob: torch.Tensor) -> LWLState:
        """Position and size from the previous mask; the scale change per
        frame clipped to `max_scale_change`."""
        p = self.params
        pos, target_sz = self._seg_to_state(state, prev_prob)
        new_scale = torch.sqrt(torch.prod(target_sz, dim=-1) /
                               torch.prod(state.base_target_sz, dim=-1))
        ratio = new_scale / state.target_scale
        lo, hi = p.max_scale_change
        new_scale = torch.where(ratio < lo, state.target_scale * lo,
                                torch.where(ratio > hi, state.target_scale * hi, new_scale))
        return dataclasses.replace(state, pos=pos, target_scale=new_scale,
                                   target_sz=state.base_target_sz * new_scale[:, None])

    def _segment(self, state: LWLState, backbone_feat, test_x):
        """Crop logits (O, Hs, Ws) and the values the step reads back
        besides (none in LWL)."""
        seg_crop, _ = self.net.segment_target(state.target_filter, test_x[None], backbone_feat,
                                              self.params.image_sample_size)
        return seg_crop, {}

    def _step(self, state: LWLState, im: torch.Tensor, prev_prob: torch.Tensor):
        """One frame for O objects: prev_prob (O, H, W) probabilities."""
        state = dataclasses.replace(state, frame_num=state.frame_num + 1)
        state = self._update_target_model(state, prev_prob)
        state = self._new_geometry(state, prev_prob)
        patch, coords = self._crop(im, state.pos, state.target_scale, state.image_sz)
        backbone_feat = self.net.extract_backbone(patch)
        test_x = self.net.extract_target_model_features(backbone_feat)
        seg_crop, extra = self._segment(state, backbone_feat, test_x)
        state = dataclasses.replace(state, prev_pos=state.pos, prev_scale=state.target_scale,
                                    prev_test_x=test_x)
        vals, inside = self._paste(seg_crop, coords, im.shape[-2], im.shape[-1])
        seg_raw_im = torch.where(inside, vals, -100.0)
        prob_im = torch.sigmoid(seg_raw_im)
        out_pos, out_sz = self._seg_to_state(state, prob_im)
        bbox = torch.cat([out_pos.flip(-1) - (out_sz.flip(-1) - 1) / 2, out_sz.flip(-1)], dim=-1)
        state = dataclasses.replace(state, seg_raw=prob_im)
        out = {"target_bbox": bbox, "segmentation_raw": seg_raw_im,
               "segmentation": (seg_raw_im > 0.0).to(torch.uint8), **extra}
        return self._finish_step(state, out, backbone_feat, coords)

    def _finish_step(self, state, out, backbone_feat, coords):
        """State updates after the paste (none in LWL)."""
        return state, out

    # ---------------------------------------------------------------- memory

    def _update_memory(self, state: LWLState, sample: torch.Tensor, mask: torch.Tensor,
                       lr: float) -> LWLState:
        """Weighted replacement in the sample memory of each object: the
        next empty slot, or once full the slot after the initial ones with
        the least weight; the weights renormalised with the initial samples'
        share kept at least `init_samples_minimum_weight`."""
        p = self.params
        M = p.sample_memory_size
        O = sample.shape[0]
        sw = state.mem_weights                                            # (O, M)
        num_init = state.num_init
        init_w = p.init_samples_minimum_weight
        idx = self._mem_idx
        if state.num_stored < M:
            r_ind = torch.full((O,), state.num_stored, dtype=torch.long, device=self.device)
        else:
            s_ind = num_init if init_w > 0 else 0
            r_ind = torch.argmin(torch.where(idx >= s_ind, sw, math.inf), dim=-1)
        prev = state.prev_ind
        sw_new = torch.where(prev[:, None] < 0, sw / (1 - lr), sw)
        prev_w = torch.gather(sw, 1, torch.clamp(prev, min=0)[:, None])[:, 0]
        new_w = torch.where(prev < 0, lr, prev_w / (1 - lr))
        sw_new = torch.where(idx == r_ind[:, None], new_w[:, None], sw_new)
        sw_new = sw_new / sw_new.sum(dim=-1, keepdim=True)
        if init_w > 0:
            init_mask = idx < num_init
            init_sum = torch.where(init_mask, sw_new, 0.0).sum(dim=-1, keepdim=True)
            rest_sum = torch.where(~init_mask, sw_new, 0.0).sum(dim=-1, keepdim=True)
            sw_adj = torch.where(init_mask, init_w / max(num_init, 1),
                                 sw_new / (init_w + rest_sum))
            sw_new = torch.where(init_sum < init_w, sw_adj, sw_new)
        obj = torch.arange(O, device=self.device)
        state.mem_samples.index_put_((r_ind, obj), sample)
        state.mem_masks.index_put_((r_ind, obj), mask)
        return dataclasses.replace(state, mem_weights=sw_new,
                                   num_stored=min(state.num_stored + 1, M), prev_ind=r_ind)

    def _run_model_update(self, state: LWLState) -> LWLState:
        """Re-encode every memory mask and refine the filter over the memory
        for `net_opt_update_iter` steps."""
        label, fs_sw = self.net.label_encode(state.mem_masks, state.mem_samples)
        sw = fs_sw * state.mem_weights.T[:, :, None, None, None]
        new_filter = self.net.tm_update_filter(state.target_filter, state.mem_samples, label,
                                               sw, self.params.net_opt_update_iter)
        return dataclasses.replace(state, target_filter=new_filter)

    # ---------------------------------------------------------------- merging

    def merge_results(self, out_all: Dict) -> Dict:
        """Soft-aggregation merge of per-object raw scores on the host: the
        background's probability is the product of the objects' complements,
        each label's aggregated probability a softmax over (background,
        objects), the label map its argmax."""
        obj_ids = list(out_all.keys())
        seg_scores = []
        for oid in obj_ids:
            o = out_all[oid]
            if "segmentation_raw" in o:
                seg_scores.append(np.asarray(o["segmentation_raw"], np.float32))
            else:
                seg_scores.append((np.asarray(o["segmentation"], np.float32) - 0.5) * 200.0)
        seg_scores = np.clip(np.stack(seg_scores), -50.0, 50.0)
        prob = 1.0 / (1.0 + np.exp(-seg_scores))
        eps = 1e-7
        bg_p = np.clip(np.prod(1 - prob, axis=0), eps, 1 - eps)
        bg_score = np.log(bg_p / (1 - bg_p))
        all_scores = np.concatenate([bg_score[None], seg_scores], axis=0)
        agg = np.stack([1.0 / np.exp(all_scores - s[None]).sum(axis=0) for s in all_scores])
        ids_all = np.array([0] + [int(i) for i in obj_ids], np.uint8)
        out = OrderedDict()
        out["segmentation"] = ids_all[agg.argmax(axis=0)]
        out["segmentation_raw"] = OrderedDict((oid, agg[i + 1]) for i, oid in enumerate(obj_ids))
        out["target_bbox"] = {oid: out_all[oid].get("target_bbox") for oid in obj_ids}
        return out


def merge_scores(raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft aggregation of (O, H, W) object logits on the device: the label
    map (H, W) uint8 (0 = background, i = object i) and the aggregated
    object probabilities (O, H, W)."""
    prob = torch.sigmoid(raw)
    eps = 1e-7
    bg_p = torch.clamp(torch.prod(1.0 - prob, dim=0), eps, 1 - eps)
    bg_score = torch.log(bg_p / (1.0 - bg_p))
    agg = torch.softmax(torch.cat([bg_score[None], raw], dim=0), dim=0)
    return torch.argmax(agg, dim=0).to(torch.uint8), agg[1:]


class LWLMultiObjectTracker:
    """All objects of a sequence in one batched step (the JAX package's
    vmapped multi-object mode): one backbone pass over the O crops, one
    grouped target model, one decoder batch, and the soft-aggregation merge
    on the device, whose aggregated probabilities stay there as the next
    frame's previous masks. One readback per frame. The harness takes it
    for a multi-object sequence under PYTRACKING_TPU_VMAP_MULTIOBJ=1
    (`LWLTracker.vmap_multiobj_class`); every object starts on the first
    frame."""

    multiobj_mode = "vmap"

    def __init__(self, params: LWLParams, net, device="cuda"):
        self.params = params
        self._impl = LWLTracker(params, net, device)
        self.device = self._impl.device
        self.states: Optional[LWLState] = None
        self.object_ids: list = []
        self._prev_probs: Optional[torch.Tensor] = None

    @torch.no_grad()
    @ieee_float32()
    def initialize(self, image, info: Dict[str, Any]) -> dict:
        """info['init_mask'] (H, W) label map; info['object_ids'] the labels
        to track (default ['1']). Each object's box is its mask's extent."""
        impl = self._impl
        im = impl._image_tensor(image)
        self.object_ids = [str(o) for o in (info.get("object_ids") or ["1"])]
        masks_full = np.asarray(info["init_mask"])
        masks, bboxes = [], []
        for oid in self.object_ids:
            m = (masks_full == int(oid)).astype(np.float32)
            ys, xs = np.nonzero(m)
            bboxes.append([xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1]
                          if len(ys) else [0, 0, 1, 1])
            masks.append(m)
        masks = torch.from_numpy(np.stack(masks)).to(self.device)
        self.states = impl._initialize(im, impl._f32(np.asarray(bboxes, np.float32)), masks)
        self._prev_probs = masks
        return {"segmentation": np.asarray(masks_full, np.uint8)}

    @torch.no_grad()
    @ieee_float32()
    def track(self, image, info: Optional[dict] = None) -> dict:
        impl = self._impl
        im = impl._image_tensor(image)
        self.states, out = impl._step(self.states, im, self._prev_probs)
        label, agg_fg = merge_scores(out["segmentation_raw"])
        self._prev_probs = agg_fg
        O, H, W = agg_fg.shape
        host = impl._readback([agg_fg, out["target_bbox"]], label)
        agg = host["floats"][:O * H * W].reshape(O, H, W)
        bboxes = host["floats"][O * H * W:].reshape(O, 4)
        ids_all = np.array([0] + [int(o) for o in self.object_ids], np.uint8)
        return {"segmentation": ids_all[host["bytes"].reshape(H, W)],
                "segmentation_raw": OrderedDict((oid, agg[i])
                                                for i, oid in enumerate(self.object_ids)),
                "target_bbox": {oid: bboxes[i].tolist() for i, oid in enumerate(self.object_ids)}}


LWLTracker.vmap_multiobj_class = LWLMultiObjectTracker


def get_tracker_class():
    return LWLTracker
