"""DiMP tracker: meta-learned discriminative filter with IoU-Net box
refinement (counterpart of pytracking_tpu/trackers/dimp.py `DiMPParams`,
`DiMPTracker`). One class runs the whole DiMP family: DiMP-18/50,
PrDiMP-18/50 (softmax scores), SuperDiMP and SuperDiMP-simple ('inside_major'
crops, box refinement in the relative box space); the net brings the
backbone and the filter optimiser.

The per-frame state is fixed-shape tensors on the tracker's device: the
target geometry, the filter, a ring buffer of `sample_memory_size`
classification features with a weight per slot (weight 0 = empty), the
IoU-Net modulation vectors and the last flag. Localisation, the four flags
(0 normal, 1 not_found, 2 hard_negative, 3 uncertain), box refinement and
the memory update run on the device. `track` reads back the box, score and
flag in one copy, the frame's one synchronisation; the flag and the frame
count then choose the classifier update on the host (no update, the
hard-negative or the periodic iteration count), and the optimiser is
enqueued after the readback, ahead of the next frame's classification.
With `defer_classifier_update` the step never refits; the caller runs
`update_classifier_deferred` (the periodic count, masked on the device by
the last flag).

The step is written over a leading stream axis (`_step_streams` on a
`BatchedDiMPState`): the batched server (`parallel/serving.py`) runs B
streams through it, and a single tracker is its one-stream case, its state
viewed as a batch of one. So does the crop (`_crop_streams`), and the
served refit (`_serve_refit`: the deferred tick, or the fused refit chosen
from the flags). KYS writes its own stream-axis step on the stream-axis
helpers; KeepTrack keeps a single-stream step and calls the one-stream
wrappers `_localize`, `_refine_target_box` and `_update_memory_masked`;
ATOM calls `refine_target_box`.

The IoU-Net box gradient is `torch.autograd.grad` of the summed IoU in the
proposal boxes, inside `torch.no_grad()` with grad enabled for that call;
the net's parameters are frozen, so no parameter gradient is built.

Random draws (the box jitter, the dropout mask) come from a
`torch.Generator` on the tracker's device seeded at `initialize`, through
`_uniform` and `_keep_mask`; the augmentation shifts come from
`np.random.RandomState(seed)`.
"""

from __future__ import annotations

import dataclasses
import math
import types
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from pytracking_tpu_torch.ops import activation as act
from pytracking_tpu_torch.ops import augmentation as aug
from pytracking_tpu_torch.ops import dcf
from pytracking_tpu_torch.ops.bbox import rect_to_rel, rel_to_rect
from pytracking_tpu_torch.ops.patch import sample_patch
from pytracking_tpu_torch.trackers.base import (BaseTracker, StreamLayout, masked_stream_slots_set,
                                                one_stream_step)
from pytracking_tpu_torch.utils.device import ieee_float32

FLAG_NORMAL, FLAG_NOT_FOUND, FLAG_HARD_NEG, FLAG_UNCERTAIN = 0, 1, 2, 3
FLAG_NAMES = ["normal", "not_found", "hard_negative", "uncertain"]


@dataclass(frozen=True)
class DiMPParams:
    """Static tracker configuration: the JAX package's fields and defaults
    (DiMP-50's). `iounet_augmentation` and `train_sample_interval` are
    declared there and read nowhere; they are kept so that the parameter
    modules map one to one."""
    image_sample_size: int = 18 * 16
    search_area_scale: float = 5.0
    # a not_found frame reports [-1, -1, -1, -1] (long-term protocols)
    output_not_found_box: bool = False
    border_mode: str = "replicate"           # 'replicate' | 'inside' | 'inside_major'
    patch_max_scale_change: Optional[float] = None
    feature_stride: int = 16
    kernel_size: int = 4
    # learning
    sample_memory_size: int = 50
    learning_rate: float = 0.01
    init_samples_minimum_weight: float = 0.25
    train_skipping: int = 20
    train_sample_interval: int = 1
    update_classifier: bool = True
    net_opt_iter: int = 10
    net_opt_update_iter: int = 2
    net_opt_hn_iter: int = 1
    # detection
    window_output: bool = False
    score_preprocess: str = "none"           # 'none' | 'exp' | 'softmax'
    softmax_reg: Optional[float] = None
    # init augmentation
    use_augmentation: bool = True
    augmentation: tuple = (("fliplr", True),
                           ("rotate", (10, -10, 45, -45)),
                           ("blur", ((3, 1), (1, 3), (2, 2))),
                           ("relativeshift", ((0.6, 0.6), (-0.6, 0.6), (0.6, -0.6),
                                              (-0.6, -0.6))),
                           ("dropout", (2, 0.2)))
    augmentation_expansion_factor: float = 2.0
    random_shift_factor: float = 1 / 3
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
    update_scale_when_uncertain: bool = True
    perform_hn_without_windowing: bool = False
    target_inside_ratio: float = 0.2
    # IoU-Net
    use_iou_net: bool = True
    iounet_augmentation: bool = False
    iounet_k: int = 3
    num_init_random_boxes: int = 9
    box_jitter_pos: float = 0.1
    box_jitter_sz: float = 0.5
    maximal_aspect_ratio: float = 6.0
    box_refinement_iter: int = 5
    # a scalar, or a (pos, sz) pair: [pos, pos, sz, sz] per box coordinate
    box_refinement_step_length: object = 1.0
    box_refinement_step_decay: float = 1.0
    box_refinement_space: str = "default"     # 'default' | 'relative' (PrDiMP)
    use_iounet_pos_for_learning: bool = True
    # `track` leaves the filter as it is (the memory still updates); the
    # caller runs `update_classifier_deferred` on the train_skipping cadence
    defer_classifier_update: bool = False

    def aug_dict(self) -> dict:
        return dict(self.augmentation) if self.use_augmentation else {}


@dataclass
class DiMPState:
    pos: torch.Tensor              # (2,) (y, x)
    target_sz: torch.Tensor        # (2,) (h, w)
    target_scale: torch.Tensor     # ()
    base_target_sz: torch.Tensor   # (2,)
    image_sz: torch.Tensor         # (2,) (H, W)
    min_scale: torch.Tensor        # ()
    max_scale: torch.Tensor        # ()
    target_filter: torch.Tensor    # (1, 1, C, fh, fw)
    mem_samples: torch.Tensor      # (M, C, Hf, Wf)
    mem_boxes: torch.Tensor        # (M, 4) xywh in patch coordinates
    mem_weights: torch.Tensor      # (M,)
    num_stored: torch.Tensor       # () int32
    num_init: torch.Tensor         # () int32
    prev_ind: torch.Tensor         # () int32, -1 = none
    iou_mod3: torch.Tensor         # (1, D)
    iou_mod4: torch.Tensor         # (1, D)
    frame_num: int                 # host count: 1 after initialize
    flag: torch.Tensor             # () int32, the last localisation flag
    max_score: torch.Tensor        # ()


@dataclass
class BatchedDiMPState:
    """`DiMPState` of B streams: every per-stream field with a leading
    stream axis, the memory with the stream axis second (the filter
    optimiser's (N, S, ...) layout, so a refit reads it without a copy)."""
    pos: torch.Tensor              # (B, 2) (y, x)
    target_sz: torch.Tensor        # (B, 2) (h, w)
    target_scale: torch.Tensor     # (B,)
    base_target_sz: torch.Tensor   # (B, 2)
    image_sz: torch.Tensor         # (B, 2) (H, W)
    min_scale: torch.Tensor        # (B,)
    max_scale: torch.Tensor        # (B,)
    target_filter: torch.Tensor    # (B, 1, C, fh, fw)
    mem_samples: torch.Tensor      # (M, B, C, Hf, Wf)
    mem_boxes: torch.Tensor        # (M, B, 4) xywh in patch coordinates
    mem_weights: torch.Tensor      # (M, B)
    num_stored: torch.Tensor       # (B,) int32
    num_init: torch.Tensor         # (B,) int32
    prev_ind: torch.Tensor         # (B,) int32, -1 = none
    iou_mod3: torch.Tensor         # (B, D)
    iou_mod4: torch.Tensor         # (B, D)
    frame_num: int                 # host count, shared by the streams
    flag: torch.Tensor             # (B,) int32
    max_score: torch.Tensor        # (B,)


# DiMPState's fields by layout: the memory (stream axis second) and the ones
# with a leading axis of 1 already (the stream axis)
_MEMORY = ("mem_samples", "mem_boxes", "mem_weights")
_LEADING_ONE = ("target_filter", "iou_mod3", "iou_mod4")
_LAYOUT = StreamLayout(DiMPState, BatchedDiMPState, _MEMORY, _LEADING_ONE)
# the fields box refinement replaces, those it reads besides, the memory's
# counts, and what a refit reads
_REFINED = ("pos", "target_sz", "target_scale")
_SCALE_BOUNDS = ("base_target_sz", "min_scale", "max_scale")
_COUNTS = ("num_stored", "num_init", "prev_ind")
_REFIT = ("target_filter", "flag") + _MEMORY


def _get_iounet_box(pos, sz, sample_pos, sample_scale, img_sample_sz) -> torch.Tensor:
    """Image-coordinate target (y, x) centre and (h, w) size -> (x, y, w, h)
    box in the patch frame. Over a stream axis, pos and sz (B, 2) and
    sample_scale (B, 1)."""
    box_center = (pos - sample_pos) / sample_scale + (img_sample_sz - 1) / 2
    box_sz = sz / sample_scale
    target_ul = box_center - (box_sz - 1) / 2
    return torch.cat([target_ul.flip(-1), box_sz.flip(-1)], dim=-1)


def refine_target_boxes(p, iou_fn, state, sample_pos, sample_scale, img_sample_sz,
                        jitter_scale, uniform, found, update_scale=True):
    """IoU-Net gradient ascent per stream on the current box and
    `num_init_random_boxes` jittered copies (jitter from `uniform(shape)`,
    (B,) + shape U[0, 1) draws), in the box space (the step scaled by the box
    size) or the relative space (cx/σ, cy/σ, log w, log h), σ the current
    box's size. The step length is a scalar or a (pos, sz) pair, the pair
    giving [pos, pos, sz, sz] per coordinate. The mean of the best
    `iounet_k` boxes of valid aspect ratio becomes the target where `found`.
    `iou_fn` maps (B, P, 4) patch boxes to (B, P) IoUs; each IoU depends on
    its own box only, so one gradient of the sum is every box's own.
    `state` brings pos, target_sz (B, 2), target_scale, base_target_sz and
    the scale bounds; sample_pos (B, 2), sample_scale and found (B,).
    Returns the new (pos (B, 2), target_sz (B, 2), target_scale (B,))."""
    init_box = _get_iounet_box(state.pos, state.target_sz, sample_pos, sample_scale[:, None],
                               img_sample_sz)                                # (B, 4)
    square_sz = torch.sqrt(torch.prod(init_box[:, 2:], -1))
    rand_bb = (uniform((p.num_init_random_boxes, 4)) - 0.5) * \
        (square_sz[:, None, None] * jitter_scale)                           # (B, K, 4)
    new_sz = torch.maximum(init_box[:, None, 2:] + rand_bb[..., 2:],
                           (init_box[:, 2:].amin(-1) / 3)[:, None, None])
    new_center = (init_box[:, :2] + init_box[:, 2:] / 2)[:, None] + rand_bb[..., :2]
    jittered = torch.cat([new_center - new_sz / 2, new_sz], dim=-1)
    boxes = torch.cat([init_box[:, None], jittered], dim=1)                  # (B, K + 1, 4)

    step = p.box_refinement_step_length
    if isinstance(step, (tuple, list)):
        # filled on the device: a host tensor uploaded mid-frame would
        # synchronise
        pos_step, sz_step = step
        step = torch.where(torch.arange(4, device=boxes.device) < 2, float(pos_step),
                           float(sz_step))
    if p.box_refinement_space == "relative":
        sz_norm = boxes[:, 0:1, 2:]
        boxes_rel = rect_to_rel(boxes, sz_norm)
        for _ in range(p.box_refinement_iter):
            with torch.enable_grad():
                b = boxes_rel.detach().requires_grad_(True)
                grad, = torch.autograd.grad(iou_fn(rel_to_rect(b, sz_norm)).sum(), b)
            boxes_rel = boxes_rel + step * grad
            step = step * p.box_refinement_step_decay
        boxes = rel_to_rect(boxes_rel, sz_norm)
    else:
        for _ in range(p.box_refinement_iter):
            with torch.enable_grad():
                b = boxes.detach().requires_grad_(True)
                grad, = torch.autograd.grad(iou_fn(b).sum(), b)
            boxes = boxes + step * grad * boxes[..., 2:].repeat(1, 1, 2)
            step = step * p.box_refinement_step_decay
    iou = iou_fn(boxes)

    # drop degenerate aspect ratios by -inf
    boxes = torch.cat([boxes[..., :2], torch.clamp(boxes[..., 2:], min=1.0)], dim=-1)
    ar = boxes[..., 2] / boxes[..., 3]
    valid = (ar < p.maximal_aspect_ratio) & (ar > 1 / p.maximal_aspect_ratio)
    iou = torch.where(valid, iou, -math.inf)

    # top k, the first index on ties (stable sort, as lax.top_k)
    k = min(p.iounet_k, boxes.shape[1])
    top_iou, top_idx = torch.sort(iou, dim=-1, descending=True, stable=True)
    top_iou, top_idx = top_iou[:, :k], top_idx[:, :k]
    top_valid = torch.isfinite(top_iou)
    denom = torch.clamp(top_valid.sum(-1), min=1)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    pred_box = torch.where(top_valid[..., None], top_boxes, 0.0).sum(1) / denom[:, None]

    new_pos = pred_box[:, :2] + pred_box[:, 2:] / 2
    new_pos = (new_pos.flip(-1) - (img_sample_sz - 1) / 2) * sample_scale[:, None] + sample_pos
    new_target_sz = pred_box[:, 2:].flip(-1) * sample_scale[:, None]
    new_scale = torch.sqrt(torch.prod(new_target_sz, -1) / torch.prod(state.base_target_sz, -1))

    apply = found & valid.any(-1)
    new_scale = torch.minimum(torch.maximum(new_scale, state.min_scale), state.max_scale)
    return (torch.where((apply & p.use_iounet_pos_for_learning)[:, None], new_pos, state.pos),
            torch.where(apply[:, None], new_target_sz, state.target_sz),
            torch.where(apply & update_scale, new_scale, state.target_scale))


def _one(x):
    """A per-stream scalar of one stream (a 0-dim tensor, or True) as (1,)."""
    return x.reshape(1) if isinstance(x, torch.Tensor) else x


def refine_target_box(p, iou_fn, state, sample_pos, sample_scale, img_sample_sz,
                      jitter_scale, uniform, found, update_scale=True):
    """`refine_target_boxes` for one stream: `iou_fn` maps (P, 4) boxes to
    (P,) IoUs, `uniform(shape)` returns shape; the state's fields, sample_pos
    (2,), sample_scale and found () carry no stream axis. ATOM uses it."""
    one = types.SimpleNamespace(**{n: getattr(state, n)[None] for n in _REFINED + _SCALE_BOUNDS})
    new = refine_target_boxes(p, lambda b: iou_fn(b[0])[None], one, sample_pos[None],
                              _one(sample_scale), img_sample_sz, jitter_scale,
                              lambda shape: uniform(shape)[None], _one(found), _one(update_scale))
    return tuple(x[0] for x in new)


class DiMPTracker(BaseTracker):
    """One instance tracks one target in one sequence."""

    # the step honours params.defer_classifier_update
    supports_deferred_classifier_update = True
    _layout = _LAYOUT

    def __init__(self, params: DiMPParams, net, device="cuda"):
        super().__init__(params, device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        # per-frame constants, uploaded once (a host tensor copied to the
        # card mid-frame would synchronise)
        s = params.image_sample_size
        self._img_sample_sz = self._f32([s, s])
        self._score_center = self._f32([(self._score_sz - 1) / 2] * 2)
        self._jitter_scale = self._f32([params.box_jitter_pos] * 2 + [params.box_jitter_sz] * 2)
        self._window = dcf.hann2d((self._score_sz,) * 2, self.device) \
            if params.window_output else None
        self.state: Optional[DiMPState] = None
        self._seed = 0
        self._generator: Optional[torch.Generator] = None

    def _f32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=self.device)

    @property
    def _feature_sz(self) -> int:
        return self.params.image_sample_size // self.params.feature_stride

    @property
    def _score_sz(self) -> int:
        return self._feature_sz + (self.params.kernel_size + 1) % 2

    # ---------------------------------------------------------------- draws

    def _uniform(self, shape) -> torch.Tensor:
        """U[0, 1) draws (the box jitter)."""
        return torch.rand(shape, generator=self._generator, device=self.device)

    def _keep_mask(self, shape, prob: float) -> torch.Tensor:
        """Bernoulli(1 - prob) keep mask (the dropout augmentation)."""
        return torch.rand(shape, generator=self._generator, device=self.device) < 1.0 - prob

    # ---------------------------------------------------------------- host API

    @torch.no_grad()
    @ieee_float32()
    def initialize(self, image, info: Dict[str, Any]) -> dict:
        """image (H, W, 3) RGB; info['init_bbox'] = [x, y, w, h]."""
        im = self._image_tensor(image)
        bbox = self._f32(info["init_bbox"])
        self._generator = torch.Generator(device=self.device).manual_seed(self._seed)
        self._aug_rng = np.random.RandomState(self._seed)
        image_sz = self._f32([im.shape[1], im.shape[2]])
        self.state = self._initialize_from_patch(self._init_crop(im, bbox, image_sz), bbox,
                                                 image_sz)
        return {}

    @torch.no_grad()
    @ieee_float32()
    def track(self, image, info: Optional[dict] = None) -> dict:
        im = self._image_tensor(image)
        patch, coords = self._track_crop(self.state, im)
        self.state, out = self._track_from_patch(self.state, patch, coords)
        host = torch.cat([out["target_bbox"], out["max_score"][None],
                          out["flag"][None].float()]).cpu().numpy()    # the one sync
        flag = int(host[5])
        self._update_classifier(flag)
        bbox = host[:4].tolist()
        if self.params.output_not_found_box and flag == FLAG_NOT_FOUND:
            bbox = [-1, -1, -1, -1]
        return {"target_bbox": bbox, "max_score": float(host[4]), "flag": FLAG_NAMES[flag]}

    @torch.no_grad()
    @ieee_float32()
    def update_classifier_deferred(self) -> None:
        """The deferred classifier update (`defer_classifier_update`): one
        optimiser pass over the memory with the periodic iteration count,
        kept on the device only where the last flag allows an update. The
        caller runs it on the train_skipping cadence."""
        self.state = dataclasses.replace(self.state, target_filter=self._refit_streams(
            types.SimpleNamespace(**_LAYOUT.one_stream(self.state, _REFIT)),
            self.params.net_opt_update_iter, mask_by_flag=True))

    # ---------------------------------------------------------------- initialize

    def _target_geometry(self, bbox):
        """(y, x) centre, (h, w) size and the sample scale of an xywh box."""
        pos = torch.stack([bbox[1] + (bbox[3] - 1) / 2, bbox[0] + (bbox[2] - 1) / 2])
        target_sz = torch.stack([bbox[3], bbox[2]])
        search_area = torch.prod(target_sz * self.params.search_area_scale)
        target_scale = torch.sqrt(search_area) / torch.sqrt(torch.prod(self._img_sample_sz))
        return pos, target_sz, target_scale

    def _init_crop(self, im, bbox, image_sz) -> torch.Tensor:
        """The expanded base patch the augmentations are cut from."""
        p = self.params
        pos, _, target_scale = self._target_geometry(bbox)
        exp_sz = int(round(p.image_sample_size * p.augmentation_expansion_factor))
        exp_sz += (exp_sz - p.image_sample_size) % 2
        base_patch, _ = sample_patch(im, torch.round(pos), (target_scale * exp_sz).expand(2),
                                     (exp_sz, exp_sz), mode=p.border_mode,
                                     max_scale_change=p.patch_max_scale_change, im_sz=image_sz)
        return base_patch

    def _initialize_from_patch(self, base_patch, bbox, image_sz) -> DiMPState:
        p = self.params
        net = self.net
        s = p.image_sample_size
        img_sample_sz = self._img_sample_sz
        pos, target_sz, target_scale = self._target_geometry(bbox)
        base_target_sz = target_sz / target_scale
        init_sample_pos = torch.round(pos)

        augs = p.aug_dict()
        transforms = aug.build_transforms({k: v for k, v in augs.items() if k != "dropout"},
                                          (s, s), p.random_shift_factor, self._aug_rng)
        im_patches = aug.apply_all(base_patch, transforms, (s, s))       # (T, 3, s, s)
        backbone_feat = net.extract_backbone(im_patches)
        x = net.extract_classification_feat(backbone_feat)               # (T, C, Hf, Wf)

        num_drop = 0
        if "dropout" in augs:
            num_drop, prob = augs["dropout"]
            keep = self._keep_mask((num_drop, x.shape[1], 1, 1), prob)
            x = torch.cat([x, aug.dropout2d(x, keep, prob)])

        cls_target_box = _get_iounet_box(pos, target_sz, init_sample_pos, target_scale,
                                         img_sample_sz)
        shifts = [[t.shift[1], t.shift[0], 0.0, 0.0] for t in transforms]
        shifts = self._f32(shifts + shifts[:1] * num_drop)
        target_boxes = cls_target_box + shifts                           # (T + D, 4)

        target_filter = net.classifier.get_filter(x[:, None], target_boxes[:, None],
                                                  num_iter=p.net_opt_iter)

        M = p.sample_memory_size
        n_init = x.shape[0]
        mem_samples = x.new_zeros((M,) + x.shape[1:])
        mem_samples[:n_init] = x
        mem_boxes = x.new_zeros((M, 4))
        mem_boxes[:n_init] = target_boxes
        mem_weights = x.new_zeros((M,))
        mem_weights[:n_init] = 1.0 / n_init

        # IoU-Net modulation from the first (identity) sample
        bfeat_first = {k: v[:1] for k, v in backbone_feat.items()}
        mod3, mod4 = net.bb_regressor.get_modulation(net.get_backbone_bbreg_feat(bfeat_first),
                                                     target_boxes[None, 0])

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)

        return DiMPState(
            pos=pos, target_sz=target_sz, target_scale=target_scale,
            base_target_sz=base_target_sz, image_sz=image_sz,
            min_scale=torch.max(10.0 / base_target_sz),
            max_scale=torch.min(image_sz / base_target_sz),
            target_filter=target_filter, mem_samples=mem_samples, mem_boxes=mem_boxes,
            mem_weights=mem_weights, num_stored=i32(n_init), num_init=i32(n_init),
            prev_ind=i32(-1), iou_mod3=mod3, iou_mod4=mod4, frame_num=1,
            flag=i32(FLAG_NORMAL), max_score=torch.ones((), device=self.device))

    # ---------------------------------------------------------------- track

    def _track_crop(self, state: DiMPState, im):
        """The search patch around the target and its extent in the image."""
        p = self.params
        feat_sz = float(self._feature_sz)
        centered_pos = state.pos + ((feat_sz + p.kernel_size) % 2) * \
            state.target_scale * self._img_sample_sz / (2 * feat_sz)
        s = p.image_sample_size
        return sample_patch(im, centered_pos, state.target_scale * self._img_sample_sz, (s, s),
                            mode=p.border_mode, max_scale_change=p.patch_max_scale_change,
                            im_sz=state.image_sz)

    def _track_from_patch(self, state: DiMPState, patch, coords):
        """The step of one stream: `_step_streams` on a batch of one."""
        return one_stream_step(self._layout, self._step_streams, state, patch, coords,
                               lambda shape: self._uniform(shape)[None])

    def _crop_streams(self, state: BatchedDiMPState, frames):
        """`_track_crop` of B streams in one batched crop: the search patches
        (B, 3, s, s) of frames (B, 3, H, W) and their extents (B, 4)."""
        p = self.params
        feat_sz = float(self._feature_sz)
        centered_pos = state.pos + ((feat_sz + p.kernel_size) % 2) * \
            state.target_scale[:, None] * self._img_sample_sz / (2 * feat_sz)
        s = p.image_sample_size
        return sample_patch(frames, centered_pos, state.target_scale[:, None] * self._img_sample_sz,
                            (s, s), mode=p.border_mode, max_scale_change=p.patch_max_scale_change,
                            im_sz=state.image_sz)

    def _step_streams(self, state: BatchedDiMPState, patch, coords, uniform):
        """One frame of B streams from their search patches (B, 3, s, s) and
        the patches' extents (B, 4) in the images: (the new state,
        {'target_bbox' (B, 4), 'max_score' (B,), 'flag' (B,)}), all on the
        device. The memory is updated in place; the filter is left as it is
        (the refit follows the readback). `uniform(shape)` returns (B,) +
        shape U[0, 1) draws (the box jitter)."""
        p = self.params
        net = self.net
        img_sample_sz = self._img_sample_sz
        state = dataclasses.replace(state, frame_num=state.frame_num + 1)

        sample_pos = 0.5 * (coords[:, :2] + coords[:, 2:])
        sample_scale = torch.sqrt(torch.prod((coords[:, 2:] - coords[:, :2]) / img_sample_sz, -1))

        backbone_feat = net.extract_backbone(patch)
        test_x = net.extract_classification_feat(backbone_feat)              # (B, C, Hf, Wf)
        scores = net.classifier.classify(state.target_filter, test_x)[:, 0]  # (B, Hs, Ws)
        if p.score_preprocess == "exp":
            scores = torch.exp(scores)
        elif p.score_preprocess == "softmax":
            scores = act.softmax_reg(scores.flatten(1), dim=-1,
                                     reg=p.softmax_reg).reshape(scores.shape)

        translation_vec, flag, max_score = self._localize_streams(state, scores, sample_pos,
                                                                  sample_scale)
        new_pos = sample_pos + translation_vec
        found = flag != FLAG_NOT_FOUND
        if not p.use_iou_net:
            # without IoU-Net the crop scale becomes the target scale on each
            # found frame, before the clamp below uses the new size
            new_scale = torch.minimum(torch.maximum(sample_scale, state.min_scale),
                                      state.max_scale)
            state = dataclasses.replace(
                state, target_scale=torch.where(found, new_scale, state.target_scale),
                target_sz=torch.where(found[:, None], state.base_target_sz * new_scale[:, None],
                                      state.target_sz))
        inside_offset = (p.target_inside_ratio - 0.5) * state.target_sz
        clamped = torch.maximum(torch.minimum(new_pos, state.image_sz - inside_offset),
                                inside_offset)
        state = dataclasses.replace(state, pos=torch.where(found[:, None], clamped, state.pos))

        if p.use_iou_net:
            update_scale = True if p.update_scale_when_uncertain else flag != FLAG_UNCERTAIN
            refined = self._refine_streams(state, backbone_feat, sample_pos, sample_scale, found,
                                           update_scale, uniform)
            state = dataclasses.replace(state, **dict(zip(_REFINED, refined)))

        if p.update_classifier:
            update_flag = (flag != FLAG_NOT_FOUND) & (flag != FLAG_UNCERTAIN)
            target_box = _get_iounet_box(state.pos, state.target_sz, sample_pos,
                                         sample_scale[:, None], img_sample_sz)
            lr = torch.where(flag == FLAG_HARD_NEG, p.hard_negative_learning_rate,
                             p.learning_rate)
            state = dataclasses.replace(state, **self._update_memory_streams(
                state, test_x, target_box, lr, update_flag))

        state = dataclasses.replace(state, flag=flag, max_score=max_score)
        bbox = torch.cat([state.pos.flip(-1) - (state.target_sz.flip(-1) - 1) / 2,
                          state.target_sz.flip(-1)], dim=-1)
        return state, {"target_bbox": bbox, "max_score": max_score, "flag": flag}

    # ---------------------------------------------------------------- localisation

    def _localize(self, state: DiMPState, scores, sample_pos, sample_scale):
        """`_localize_streams` for one stream: scores (Hs, Ws) -> (translation
        (2,), flag () int32, max score ())."""
        one = types.SimpleNamespace(pos=state.pos[None], target_sz=state.target_sz[None])
        trans, flag, max_score = self._localize_streams(one, scores[None], sample_pos[None],
                                                        _one(sample_scale))
        return trans[0], flag[0], max_score[0]

    def _localize_streams(self, state, scores, sample_pos, sample_scale):
        """Localisation per stream on the (B, Hs, Ws) score maps, with the
        distractor analysis when `advanced_localization`: (translation
        (B, 2), flag (B,) int32, max score (B,))."""
        p = self.params
        img_sample_sz = self._img_sample_sz
        output_sz = float(self._feature_sz)     # score cells stride the feature grid
        h, w = scores.shape[-2], scores.shape[-1]
        disp_to_img = (img_sample_sz / output_sz) * sample_scale[:, None]     # (B, 2)

        scores_hn = scores
        if self._window is not None and p.perform_hn_without_windowing:
            # the window applies to the primary peak only in this mode
            scores = scores * self._window

        max_score1, max_disp1 = dcf.max2d(scores)
        max_disp1 = max_disp1.float()
        target_disp1 = max_disp1 - self._score_center
        translation_vec1 = target_disp1 * disp_to_img
        if not p.advanced_localization:
            return (translation_vec1,
                    torch.zeros(scores.shape[:1], dtype=torch.int32, device=scores.device),
                    max_score1)

        # mask the target neighbourhood and find the second peak
        target_neigh_sz = p.target_neighborhood_scale * \
            (state.target_sz / sample_scale[:, None]) * (output_sz / img_sample_sz)
        iy = torch.arange(h, dtype=torch.float32, device=scores.device)[None, :, None]
        ix = torch.arange(w, dtype=torch.float32, device=scores.device)[None, None, :]
        in_neigh = ((torch.abs(iy - max_disp1[:, 0, None, None])
                     <= target_neigh_sz[:, 0, None, None] / 2 + 0.5)
                    & (torch.abs(ix - max_disp1[:, 1, None, None])
                       <= target_neigh_sz[:, 1, None, None] / 2 + 0.5))
        max_score2, max_disp2 = dcf.max2d(torch.where(in_neigh, 0.0, scores_hn))
        target_disp2 = max_disp2.float() - self._score_center
        translation_vec2 = target_disp2 * disp_to_img

        # the previous position in score cells from this sample's centre
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

        trans = translation_vec1
        flag = torch.zeros(scores.shape[:1], dtype=torch.int32, device=scores.device)
        flag = torch.where(hard_neg2, FLAG_HARD_NEG, flag)
        flag = torch.where(uncertain_both, FLAG_UNCERTAIN, flag)
        flag = torch.where(hn2, FLAG_HARD_NEG, flag)
        trans = torch.where(hn2[:, None], translation_vec2, trans)
        flag = torch.where(hn1, FLAG_HARD_NEG, flag)
        trans = torch.where(hn1[:, None], translation_vec1, trans)
        # the score thresholds dominate, the not-found one most
        flag = torch.where(max_score1 < p.hard_sample_threshold, FLAG_HARD_NEG, flag)
        flag = torch.where(max_score1 < p.uncertain_threshold, FLAG_UNCERTAIN, flag)
        not_found = max_score1 < p.target_not_found_threshold
        flag = torch.where(not_found, FLAG_NOT_FOUND, flag)
        trans = torch.where(not_found[:, None], translation_vec1, trans)
        return trans, flag, max_score1

    # ---------------------------------------------------------------- box refinement

    def _refine_target_box(self, state: DiMPState, backbone_feat, sample_pos, sample_scale,
                           found, update_scale=True) -> DiMPState:
        """`_refine_streams` for one stream (KYS and KeepTrack call it)."""
        one = types.SimpleNamespace(**_LAYOUT.one_stream(state, _REFINED + _SCALE_BOUNDS
                                                  + ("iou_mod3", "iou_mod4")))
        refined = self._refine_streams(one, backbone_feat, sample_pos[None], _one(sample_scale),
                                       _one(found), _one(update_scale),
                                       lambda shape: self._uniform(shape)[None])
        return dataclasses.replace(state, **{n: x[0] for n, x in zip(_REFINED, refined)})

    def _refine_streams(self, state, backbone_feat, sample_pos, sample_scale, found,
                        update_scale, uniform):
        """IoU-Net ascent from each stream's box with its own modulation
        vectors (`refine_target_boxes`): the new (pos, target_sz,
        target_scale)."""
        net = self.net
        iou_feat = net.bb_regressor.get_iou_feat(net.get_backbone_bbreg_feat(backbone_feat))
        modulation = (state.iou_mod3, state.iou_mod4)
        return refine_target_boxes(
            self.params, lambda b: net.bb_regressor.predict_iou(modulation, iou_feat, b), state,
            sample_pos, sample_scale, self._img_sample_sz, self._jitter_scale, uniform, found,
            update_scale)

    # ---------------------------------------------------------------- memory

    def _update_memory_masked(self, state: DiMPState, sample, target_box, lr,
                              do_update, replace_key=None) -> DiMPState:
        """`_update_memory_streams` for one stream (KYS and KeepTrack call
        it): sample (C, Hf, Wf), target_box (4,), replace_key (M,)."""
        one = types.SimpleNamespace(**_LAYOUT.one_stream(state, _MEMORY + _COUNTS))
        new = self._update_memory_streams(one, sample[None], target_box[None], lr,
                                          _one(do_update),
                                          None if replace_key is None else replace_key[:, None])
        return dataclasses.replace(state, **_LAYOUT.unbatch(new))

    def _update_memory_streams(self, state, sample, target_box, lr, do_update,
                               replace_key=None) -> dict:
        """Weighted-replacement ring-buffer update per stream, masked by
        `do_update` (B,): each stream's new sample (B, C, Hf, Wf) and box
        (B, 4) replace its slot after the initial ones with the least
        `replace_key` (M, B) (the weight when none is given), chosen on the
        device; the B slots are written by one indexed write in place.
        Returns the new mem_weights, num_stored and prev_ind."""
        p = self.params
        M = p.sample_memory_size
        sw = state.mem_weights                                                # (M, B)
        num_init = state.num_init
        num_stored = state.num_stored
        init_w = p.init_samples_minimum_weight

        idx = torch.arange(M, device=sw.device)[:, None]
        s_ind = num_init if init_w > 0 else 0
        key = sw if replace_key is None else replace_key
        r_ind_full = torch.argmin(torch.where(idx >= s_ind, key, math.inf), dim=0)
        r_ind = torch.where(num_stored < M, num_stored.long(), r_ind_full)      # (B,)

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
                                 sw_new * (1.0 / (init_w + rest_sum)))
            sw_new = torch.where(init_sum < init_w, sw_adj, sw_new)

        masked_stream_slots_set(((state.mem_samples, sample), (state.mem_boxes, target_box)),
                                r_ind, do_update)
        return {"mem_weights": torch.where(do_update, sw_new, state.mem_weights),
                "num_stored": torch.where(do_update, torch.clamp(num_stored + 1, max=M),
                                          num_stored),
                "prev_ind": torch.where(do_update, r_ind.to(torch.int32), state.prev_ind)}

    def _classifier_iterations(self, flag: int, frame_num: int) -> int:
        """Optimiser iterations for this frame: the hard-negative count on a
        confident hard negative, the periodic count every `train_skipping`
        frames, else none."""
        p = self.params
        if flag in (FLAG_NOT_FOUND, FLAG_UNCERTAIN):
            return 0
        if flag == FLAG_HARD_NEG:
            return p.net_opt_hn_iter
        if (frame_num - 1) % p.train_skipping == 0:
            return p.net_opt_update_iter
        return 0

    def _update_classifier(self, flag: int) -> None:
        """Refit the filter over the memory, enqueued after the frame's
        readback; the next frame's classification follows it in the
        stream. None with `update_classifier` off or deferred."""
        p = self.params
        if not p.update_classifier or p.defer_classifier_update:
            return
        num_iter = self._classifier_iterations(flag, self.state.frame_num)
        if num_iter == 0:
            return
        self.state = dataclasses.replace(self.state, target_filter=self._refit_streams(
            types.SimpleNamespace(**_LAYOUT.one_stream(self.state, _REFIT)), num_iter))

    # ---------------------------------------------------------------- served refits

    @property
    def _serve_reads_flags(self) -> bool:
        """Without the deferred update the refit after a step follows its
        flags, read back on the host."""
        return not self.params.defer_classifier_update

    def _serve_tick_due(self, frame_num: int) -> bool:
        """The deferred update's tick: where the fused step's periodic
        branch fires, (frame_num - 1) % train_skipping == 0."""
        p = self.params
        return p.defer_classifier_update and (frame_num - 1) % p.train_skipping == 0

    def _serve_refit(self, state: BatchedDiMPState, flags: Optional[np.ndarray] = None):
        """After a served step: with the deferred update, the tick where it
        falls due (one optimiser pass over every stream, each masked on the
        device by its last flag); else the fused refit, each stream's count
        chosen from its flag, one optimiser call per non-zero count over
        its streams, the others' filters untouched."""
        p = self.params
        if p.defer_classifier_update:
            return self._serve_tick(state) if self._serve_tick_due(state.frame_num) else state
        if not p.update_classifier:
            return state
        groups = {}
        for b, flag in enumerate(flags):
            num_iter = self._classifier_iterations(int(flag), state.frame_num)
            if num_iter:
                groups.setdefault(num_iter, []).append(b)
        for num_iter, streams in groups.items():
            index = None
            if len(streams) < len(flags):
                index = torch.tensor(streams)
                if self.device.type == "cuda":
                    index = index.pin_memory()
                index = index.to(self.device, non_blocking=True)
            state = dataclasses.replace(state, target_filter=self._refit_streams(
                state, num_iter, index))
        return state

    def _serve_tick(self, state: BatchedDiMPState) -> BatchedDiMPState:
        """The deferred update's tick: the periodic iteration count over
        every stream, each stream's filter kept where its last flag allows
        no update."""
        return dataclasses.replace(state, target_filter=self._refit_streams(
            state, self.params.net_opt_update_iter, mask_by_flag=True))

    def _refit_streams(self, state, num_iter: int, streams: Optional[torch.Tensor] = None,
                       mask_by_flag: bool = False) -> torch.Tensor:
        """`num_iter` optimiser iterations over the memories of a stream-axis
        state, the streams as the optimiser's sequence axis: all streams, or
        those of the device index tensor `streams` (the others keep their
        filters). With `mask_by_flag` a stream keeps its filter where its
        last flag allows no update (the deferred update). Returns the
        filters (B, 1, C, fh, fw)."""
        opt = self.net.classifier.filter_optimizer
        if streams is None:
            new_filter = opt(state.target_filter, state.mem_samples, state.mem_boxes,
                             sample_weight=state.mem_weights, num_iter=num_iter)
        else:
            new_filter = state.target_filter.index_copy(0, streams, opt(
                state.target_filter[streams], state.mem_samples[:, streams],
                state.mem_boxes[:, streams], sample_weight=state.mem_weights[:, streams],
                num_iter=num_iter))
        if mask_by_flag:
            ok = (state.flag != FLAG_NOT_FOUND) & (state.flag != FLAG_UNCERTAIN)
            new_filter = torch.where(ok[:, None, None, None, None], new_filter,
                                     state.target_filter)
        return new_filter


def get_tracker_class():
    return DiMPTracker
