"""ATOM tracker: an online classifier (a projection to `compressed_dim`
channels and a 4x4 filter, learned by Gauss-Newton/CG on the first frame and
refitted from a sample memory) and IoU-Net box refinement (counterpart of
pytracking_tpu/trackers/atom.py `ATOMParams`, `ATOMTracker`).

The state is fixed-shape tensors on the tracker's device: the geometry, the
projection (Cin, cdim) and the filter (1, cdim, fh, fw), a memory of
`sample_memory_size` projected samples with their labels and a weight per
slot (weight 0 = empty), the IoU-Net modulation and the last flag. The
first frame's joint fit of filter and projection is one `gauss_newton_cg`
with ATOM's diagonal preconditioner. A frame's scores are the projected
layer3 features correlated with the filter ('same' padding, the trailing
row and column of an even filter dropped), upsampled in the Fourier domain
with the even filter's half-cell phase, and decoded on the wrap-around grid
into one of the four flags. `track` reads back the box, score and flag in
one copy; the flag and the host frame count then choose the refit (none,
the hard-negative or the periodic CG count), enqueued after the readback.

Random draws (the projection and filter init, the dropout mask, the box
jitter) come from a `torch.Generator` seeded at `initialize`, through
`_normal`, `_keep_mask` and `_uniform`; the augmentation shifts from
`np.random.RandomState(seed)`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytracking_tpu_torch.ops import augmentation as aug
from pytracking_tpu_torch.ops import dcf, fourier, solvers
from pytracking_tpu_torch.ops.activation import mlu
from pytracking_tpu_torch.ops.patch import sample_patch
from pytracking_tpu_torch.trackers.base import BaseTracker, masked_slot_set, take
from pytracking_tpu_torch.trackers.dimp import (FLAG_HARD_NEG, FLAG_NAMES, FLAG_NORMAL,
                                                FLAG_NOT_FOUND, FLAG_UNCERTAIN,
                                                _get_iounet_box, refine_target_box)
from pytracking_tpu_torch.utils.device import ieee_float32


@dataclass(frozen=True)
class ATOMParams:
    """Static tracker configuration: the JAX package's fields and defaults
    (ATOM's `default` parameters). `feature_stride` is the backbone's layer3
    stride; `iounet_augmentation` is declared there and read nowhere."""
    max_image_sample_size: int = (18 * 16) ** 2
    min_image_sample_size: int = (18 * 16) ** 2
    search_area_scale: float = 5.0
    feature_size_odd: bool = False
    feature_stride: int = 16
    kernel_size: Tuple[int, int] = (4, 4)
    compressed_dim: int = 64
    filter_reg: float = 1e-1
    projection_reg: float = 1e-4
    use_projection_matrix: bool = True
    update_projection_matrix: bool = True
    proj_init_method: str = "randn"       # 'randn' | 'pca'
    filter_init_method: str = "randn"     # 'randn' | 'zeros'
    # per-sample power normalisation of layer3; None disables
    feature_normalize_power: Optional[int] = 2
    projection_activation: str = "none"
    response_activation: Tuple[str, float] = ("mlu", 0.05)
    # optimisation
    CG_iter: int = 5
    init_CG_iter: int = 60
    init_GN_iter: int = 6
    post_init_CG_iter: int = 0
    hard_negative_CG_iter: int = 5
    # learning
    learning_rate: float = 0.01
    init_samples_minimum_weight: float = 0.25
    output_sigma_factor: float = 1 / 4
    sample_memory_size: int = 250
    train_skipping: int = 10
    # detection
    scale_factors: Tuple[float, ...] = (1.0,)
    score_upsample_factor: int = 1
    window_output: bool = False
    perform_hn_without_windowing: bool = False
    border_mode: str = "replicate"
    patch_max_scale_change: Optional[float] = None
    # init augmentation
    use_augmentation: bool = True
    augmentation: tuple = (("fliplr", True),
                           ("rotate", (5, -5, 10, -10, 20, -20, 30, -30, 45, -45,
                                       -60, 60)),
                           ("blur", ((2, 0.2), (0.2, 2), (3, 1), (1, 3), (2, 2))),
                           ("relativeshift", ((0.6, 0.6), (-0.6, 0.6), (0.6, -0.6),
                                              (-0.6, -0.6))),
                           ("dropout", (7, 0.2)))
    augmentation_expansion_factor: float = 2.0
    random_shift_factor: float = 1 / 3
    # advanced localisation
    advanced_localization: bool = True
    target_not_found_threshold: float = 0.25
    distractor_threshold: float = 0.8
    hard_negative_threshold: float = 0.5
    target_neighborhood_scale: float = 2.2
    displacement_scale: float = 0.8
    hard_negative_learning_rate: float = 0.02
    update_scale_when_uncertain: bool = True
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
    box_refinement_space: str = "default"     # 'default' | 'relative'
    use_iounet_pos_for_learning: bool = True

    def aug_dict(self) -> dict:
        return dict(self.augmentation) if self.use_augmentation else {}


@dataclass
class ATOMState:
    pos: torch.Tensor              # (2,) (y, x)
    target_sz: torch.Tensor        # (2,) (h, w)
    target_scale: torch.Tensor     # ()
    base_target_sz: torch.Tensor   # (2,)
    image_sz: torch.Tensor         # (2,) (H, W)
    min_scale: torch.Tensor        # ()
    max_scale: torch.Tensor        # ()
    sigma: torch.Tensor            # (2,) label sigma in feature cells
    filt: torch.Tensor             # (1, cdim, fh, fw)
    proj: torch.Tensor             # (Cin, cdim)
    mem_samples: torch.Tensor      # (M, cdim, Hf, Wf)
    mem_y: torch.Tensor            # (M, Hf, Wf)
    mem_weights: torch.Tensor      # (M,)
    num_stored: torch.Tensor       # () int32
    num_init: torch.Tensor         # () int32
    prev_ind: torch.Tensor         # () int32, -1 = none
    iou_mod3: torch.Tensor         # (1, D)
    iou_mod4: torch.Tensor         # (1, D)
    frame_num: int                 # host count: 1 after initialize
    flag: torch.Tensor             # () int32
    max_score: torch.Tensor        # ()


def _conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) correlated with w (K, C, fh, fw): f // 2 padding on both
    sides, the trailing row / column dropped for an even filter."""
    fh, fw = w.shape[-2], w.shape[-1]
    out = F.conv2d(x, w, padding=(fh // 2, fw // 2))
    if fh % 2 == 0:
        out = out[:, :, :-1]
    if fw % 2 == 0:
        out = out[:, :, :, :-1]
    return out


class ATOMTracker(BaseTracker):
    """One instance tracks one target in one sequence."""

    def __init__(self, params: ATOMParams, net, device="cuda"):
        super().__init__(params, device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self._jitter_scale = self._f32([params.box_jitter_pos] * 2 + [params.box_jitter_sz] * 2)
        self._scale_factors = self._f32(list(params.scale_factors))
        self.state: Optional[ATOMState] = None
        self._seed = 0
        self._generator: Optional[torch.Generator] = None

    def _f32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=self.device)

    # ---------------------------------------------------------------- draws

    def _uniform(self, shape) -> torch.Tensor:
        """U[0, 1) draws (the box jitter)."""
        return torch.rand(shape, generator=self._generator, device=self.device)

    def _normal(self, shape) -> torch.Tensor:
        """N(0, 1) draws (the projection and filter init)."""
        return torch.randn(shape, generator=self._generator, device=self.device)

    def _keep_mask(self, shape, prob: float) -> torch.Tensor:
        """Bernoulli(1 - prob) keep mask (the dropout augmentation)."""
        return torch.rand(shape, generator=self._generator, device=self.device) < 1.0 - prob

    # ---------------------------------------------------------------- net helpers

    def _features(self, backbone_feat) -> torch.Tensor:
        """layer3 power-normalised per sample: feat / (mean |feat|^p + 1e-10)^(1/p)."""
        feat = backbone_feat["layer3"]
        q = self.params.feature_normalize_power
        if q is None:
            return feat
        return feat / (torch.mean(torch.abs(feat) ** q, dim=(1, 2, 3), keepdim=True)
                       + 1e-10) ** (1.0 / q)

    def _act(self, s: torch.Tensor, kind: str, a: float = 0.0) -> torch.Tensor:
        if kind == "mlu":
            return mlu(s, a)
        if kind == "relu":
            return F.relu(s)
        if kind == "elu":
            return F.elu(s)
        return s

    def _project(self, feat: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
        """1x1 projection (Cin, cdim) of (B, Cin, H, W), then the activation."""
        return self._act(torch.einsum("bchw,cd->bdhw", feat, proj),
                         self.params.projection_activation)

    def _scores(self, comp: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
        kind, a = self.params.response_activation
        return self._act(_conv_same(comp, filt)[:, 0], kind, a)

    # ---------------------------------------------------------------- geometry

    def _compute_sample_sz(self, target_sz: np.ndarray) -> Tuple[int, float]:
        """The square sample size (odd or even multiple of the stride) and
        the target scale, on the host."""
        p = self.params
        search_area = float(np.prod(np.asarray(target_sz) * p.search_area_scale))
        target_scale = 1.0
        if search_area > p.max_image_sample_size:
            target_scale = math.sqrt(search_area / p.max_image_sample_size)
        elif search_area < p.min_image_sample_size:
            target_scale = math.sqrt(search_area / p.min_image_sample_size)
        base_target_sz = np.asarray(target_sz) / target_scale
        stride = p.feature_stride
        sz = round(math.sqrt(float(np.prod(base_target_sz * p.search_area_scale))))
        if p.feature_size_odd:
            sz += int(stride - sz % (2 * stride))
        else:
            sz += int(stride - (sz + stride) % (2 * stride))
        return int(sz), float(target_scale)

    # ---------------------------------------------------------------- host API

    @torch.no_grad()
    @ieee_float32()
    def initialize(self, image, info: Dict[str, Any]) -> dict:
        """image (H, W, 3) RGB; info['init_bbox'] = [x, y, w, h]."""
        im = self._image_tensor(image)
        bbox_np = np.asarray(info["init_bbox"], np.float32)
        sample_sz, target_scale = self._compute_sample_sz(np.array([bbox_np[3], bbox_np[2]]))
        self._sample_sz = sample_sz
        # per-sequence constants, uploaded once (a host tensor copied to the
        # card mid-frame would synchronise): the sample size, the even
        # filter's half-cell label offset and its phase in the upsampling
        self._support = self._f32([float(sample_sz)] * 2)
        fh, fw = self.params.kernel_size
        feat_sz = sample_sz // self.params.feature_stride
        self._label_offset = self._f32([0.5 * ((fh + 1) % 2), 0.5 * ((fw + 1) % 2)])
        self._upsample_shift = self._f32([math.pi * (1 - (fh % 2) / feat_sz),
                                          math.pi * (1 - (fw % 2) / feat_sz)])
        out_sz = self.params.score_upsample_factor * sample_sz
        self._window = dcf.hann2d_uncentered((out_sz, out_sz), self.device)[None] \
            if self.params.window_output else None
        self._generator = torch.Generator(device=self.device).manual_seed(self._seed)
        self._aug_rng = np.random.RandomState(self._seed)
        bbox = self._f32(bbox_np)
        image_sz = self._f32([im.shape[1], im.shape[2]])
        target_scale = self._f32(target_scale)
        self.state = self._initialize_from_patch(
            self._init_crop(im, bbox, target_scale, image_sz), bbox, target_scale, image_sz)
        return {}

    @torch.no_grad()
    @ieee_float32()
    def track(self, image, info: Optional[dict] = None) -> dict:
        im = self._image_tensor(image)
        self.state, out = self._track_from_patch(self.state, self._track_crop(self.state, im))
        host = torch.cat([out["target_bbox"], out["max_score"][None],
                          out["flag"][None].float()]).cpu().numpy()    # the one sync
        flag = int(host[5])
        self._update_filter(flag)
        return {"target_bbox": host[:4].tolist(), "max_score": float(host[4]),
                "flag": FLAG_NAMES[flag]}

    # ---------------------------------------------------------------- initialize

    def _target_pos(self, bbox):
        return torch.stack([bbox[1] + (bbox[3] - 1) / 2, bbox[0] + (bbox[2] - 1) / 2])

    def _init_crop(self, im, bbox, target_scale, image_sz) -> torch.Tensor:
        """The expanded base patch the augmentations are cut from."""
        p = self.params
        s = self._sample_sz
        exp_sz = int(round(s * p.augmentation_expansion_factor))
        exp_sz += (exp_sz - s) % 2
        base_patch, _ = sample_patch(im, torch.round(self._target_pos(bbox)),
                                     (target_scale * exp_sz).expand(2), (exp_sz, exp_sz),
                                     mode=p.border_mode, im_sz=image_sz)
        return base_patch

    def _labels(self, centers: torch.Tensor, feat_sz: int, sigma: torch.Tensor) -> torch.Tensor:
        """Gaussian labels (N, Hf, Wf) centred at `centers` (N, 2), offsets
        from the grid's middle (k = i - (sz - 1) / 2, no wrap); the even
        filter's half-cell enters in the localisation's phase shift."""
        k = torch.arange(feat_sz, dtype=torch.float32, device=self.device) - (feat_sz - 1) / 2
        gy = torch.exp(-0.5 / sigma[0] ** 2 * (k[None, :] - centers[:, 0:1]) ** 2)
        gx = torch.exp(-0.5 / sigma[1] ** 2 * (k[None, :] - centers[:, 1:2]) ** 2)
        return gy[:, :, None] * gx[:, None, :]

    def _initialize_from_patch(self, base_patch, bbox, target_scale, image_sz) -> ATOMState:
        p = self.params
        s = self._sample_sz
        pos = self._target_pos(bbox)
        target_sz = torch.stack([bbox[3], bbox[2]])
        base_target_sz = target_sz / target_scale
        feat_sz = s // p.feature_stride
        init_pos = torch.round(pos)

        augs = p.aug_dict()
        transforms = aug.build_transforms({k: v for k, v in augs.items() if k != "dropout"},
                                          (s, s), p.random_shift_factor, self._aug_rng)
        im_patches = aug.apply_all(base_patch, transforms, (s, s))
        backbone_feat = self.net.extract_backbone(im_patches)
        x = self._features(backbone_feat)                          # (T, Cin, Hf, Wf)
        num_drop = 0
        if "dropout" in augs:
            num_drop, prob = augs["dropout"]
            x = torch.cat([x, aug.dropout2d(x, self._keep_mask((num_drop, x.shape[1], 1, 1),
                                                               prob), prob)])
        T, cin = x.shape[0], x.shape[1]

        # projection init: 'pca' the leading eigenvectors of the channel
        # covariance over the init samples, else N(0, 1 / Cin)
        if p.proj_init_method == "pca":
            x_mat = x.permute(1, 0, 2, 3).reshape(cin, -1)
            x_mat = x_mat - x_mat.mean(dim=1, keepdim=True)
            _, _, vt = torch.linalg.svd(x_mat @ x_mat.T)
            proj = vt[:p.compressed_dim].T.contiguous()
        else:
            proj = self._normal((cin, p.compressed_dim)) / math.sqrt(cin)
        fh, fw = p.kernel_size
        if p.filter_init_method == "zeros":
            filt = x.new_zeros((1, p.compressed_dim, fh, fw))
        else:
            filt = self._normal((1, p.compressed_dim, fh, fw)) / (fh * fw * p.compressed_dim)

        # labels, centred, one per sample at its augmentation's shift
        sigma = torch.sqrt(torch.prod(feat_sz / self._support * base_target_sz)) * \
            p.output_sigma_factor * torch.ones(2, device=self.device)
        center_pos = feat_sz * (pos - init_pos) / (target_scale * self._support) + \
            self._label_offset
        shifts = self._f32([list(t.shift) for t in transforms] + [list(transforms[0].shift)] *
                           num_drop)
        init_y = self._labels(center_pos[None] + shifts / s * feat_sz, feat_sz, sigma)

        # joint fit of filter and projection
        sw = torch.full((T,), 1.0 / T, device=self.device)

        def joint_residual(v):
            scores = self._scores(self._project(x, v["proj"]), v["filt"])
            return {"data": torch.sqrt(sw)[:, None, None] * (scores - init_y),
                    "f_reg": math.sqrt(p.filter_reg) * v["filt"],
                    "p_reg": math.sqrt(p.projection_reg) * v["proj"]}

        def precond(v):
            return {"filt": v["filt"] / p.filter_reg, "proj": v["proj"] / p.projection_reg}

        if p.update_projection_matrix:
            res = solvers.gauss_newton_cg(
                joint_residual, {"filt": filt, "proj": proj}, num_gn_iter=p.init_GN_iter,
                num_cg_iter=max(p.init_CG_iter // max(p.init_GN_iter, 1), 1), precond=precond)
            filt, proj = res.x["filt"], res.x["proj"]

        # memory of projected samples
        comp = self._project(x, proj)
        M = p.sample_memory_size
        mem_samples = comp.new_zeros((M,) + comp.shape[1:])
        mem_samples[:T] = comp
        mem_y = comp.new_zeros((M, feat_sz, feat_sz))
        mem_y[:T] = init_y
        mem_weights = comp.new_zeros((M,))
        mem_weights[:T] = 1.0 / T
        if p.post_init_CG_iter > 0:
            filt = self._filter_cg(filt, mem_samples, mem_y, mem_weights, p.post_init_CG_iter)

        # IoU-Net modulation from the first (identity) sample
        iou_box = _get_iounet_box(pos, target_sz, init_pos, target_scale, self._support)
        mod3, mod4 = self.net.bb_regressor.get_modulation(
            self.net.get_backbone_bbreg_feat({k: v[:1] for k, v in backbone_feat.items()}),
            iou_box[None])

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)

        return ATOMState(
            pos=pos, target_sz=target_sz, target_scale=target_scale,
            base_target_sz=base_target_sz, image_sz=image_sz,
            min_scale=torch.max(10.0 / base_target_sz),
            max_scale=torch.min(image_sz / base_target_sz), sigma=sigma, filt=filt,
            proj=proj, mem_samples=mem_samples, mem_y=mem_y, mem_weights=mem_weights,
            num_stored=i32(T), num_init=i32(T), prev_ind=i32(-1), iou_mod3=mod3,
            iou_mod4=mod4, frame_num=1, flag=i32(FLAG_NORMAL),
            max_score=torch.ones((), device=self.device))

    def _filter_cg(self, filt, mem_samples, mem_y, mem_weights, num_iter: int) -> torch.Tensor:
        """One Gauss-Newton linearisation and `num_iter` CG steps of the
        filter over the memory."""
        p = self.params
        sqrt_w = torch.sqrt(mem_weights)[:, None, None]

        def residual(f):
            return {"data": sqrt_w * (self._scores(mem_samples, f) - mem_y),
                    "reg": math.sqrt(p.filter_reg) * f}

        return solvers.gauss_newton_cg(residual, filt, num_gn_iter=1, num_cg_iter=num_iter).x

    # ---------------------------------------------------------------- track

    def _track_crop(self, state: ATOMState, im) -> torch.Tensor:
        """One sample per scale factor around the rounded position,
        (S, 3, s, s)."""
        p = self.params
        s = self._sample_sz
        S = self._scale_factors.shape[0]
        sample_sz = (self._scale_factors * state.target_scale)[:, None] * self._support
        return sample_patch(im, torch.round(state.pos).expand(S, 2), sample_sz, (s, s),
                            mode=p.border_mode, im_sz=state.image_sz)[0]

    def _track_from_patch(self, state: ATOMState, patches):
        p = self.params
        s = self._sample_sz
        support = self._support
        feat_sz = s // p.feature_stride
        out_sz = p.score_upsample_factor * s
        fh, fw = p.kernel_size
        state = dataclasses.replace(state, frame_num=state.frame_num + 1)
        sample_pos = torch.round(state.pos)
        scale_factors = self._scale_factors * state.target_scale

        backbone_feat = self.net.extract_backbone(patches)
        comp = self._project(self._features(backbone_feat), state.proj)   # (S, cdim, Hf, Wf)
        scores_raw = _conv_same(comp, state.filt)[:, 0]                   # (S, Hf, Wf)

        # Fourier-domain upsampling; the even filter's half-cell as a phase
        sf = fourier.shift_fs(fourier.cfft2(scores_raw) / (feat_sz * feat_sz),
                              self._upsample_shift)
        scores = fourier.sample_fs(sf, (out_sz, out_sz))                  # (S, out, out)
        scores_hn = scores
        if self._window is not None:
            scores = scores * self._window
            if not p.perform_hn_without_windowing:
                scores_hn = scores

        translation_vec, scale_ind, flag, max_score = self._localize(
            state, scores, scale_factors, out_sz, scores_hn)
        found = flag != FLAG_NOT_FOUND
        inside_offset = (p.target_inside_ratio - 0.5) * state.target_sz
        clamped = torch.maximum(torch.minimum(sample_pos + translation_vec,
                                              state.image_sz - inside_offset), inside_offset)
        state = dataclasses.replace(state, pos=torch.where(found, clamped, state.pos))
        sample_scale = take(scale_factors, scale_ind)

        if p.use_iou_net:
            update_scale = True if p.update_scale_when_uncertain else flag != FLAG_UNCERTAIN
            iou_feat = [f.index_select(0, scale_ind.reshape(1)) for f in
                        self.net.bb_regressor.get_iou_feat(
                            self.net.get_backbone_bbreg_feat(backbone_feat))]
            modulation = (state.iou_mod3, state.iou_mod4)
            pos, target_sz, target_scale = refine_target_box(
                p, lambda b: self.net.bb_regressor.predict_iou(modulation, iou_feat, b[None])[0],
                state, sample_pos, sample_scale, support, self._jitter_scale, self._uniform,
                found, update_scale)
            state = dataclasses.replace(state, pos=pos, target_sz=target_sz,
                                        target_scale=target_scale)
        else:
            new_scale = torch.minimum(torch.maximum(sample_scale, state.min_scale),
                                      state.max_scale)
            state = dataclasses.replace(
                state, target_scale=torch.where(found, new_scale, state.target_scale),
                target_sz=torch.where(found, state.base_target_sz * new_scale, state.target_sz))

        # memory update with this frame's sample and its label
        update_flag = (flag != FLAG_NOT_FOUND) & (flag != FLAG_UNCERTAIN)
        lr = torch.where(flag == FLAG_HARD_NEG, p.hard_negative_learning_rate, p.learning_rate)
        center = feat_sz * (state.pos - sample_pos) / (sample_scale * support) + \
            self._label_offset
        y = self._labels(center[None], feat_sz, state.sigma)[0]
        state = self._update_memory(state, comp.index_select(0, scale_ind.reshape(1))[0], y,
                                    lr, update_flag)

        state = dataclasses.replace(state, flag=flag, max_score=max_score)
        bbox = torch.cat([state.pos.flip(-1) - (state.target_sz.flip(-1) - 1) / 2,
                          state.target_sz.flip(-1)])
        return state, {"target_bbox": bbox, "max_score": max_score, "flag": flag}

    # ---------------------------------------------------------------- localisation

    def _localize(self, state: ATOMState, scores, scale_factors, out_sz: int, scores_hn):
        """Localisation on the wrap-around upsampled scores (S, out, out):
        (translation (2,), scale index (), flag () int32, max score ()).
        `scores_hn` is the map the second-peak search masks."""
        p = self.params
        disp_to_img = float(self._sample_sz) / out_sz

        max_score1, max_disp1 = dcf.max2d(scores)                  # (S,), (S, 2)
        scale_ind = torch.argmax(max_score1)
        max_score_s = take(max_score1, scale_ind)
        disp1 = take(max_disp1, scale_ind).float()
        disp1_mod = torch.remainder(disp1 + out_sz / 2, out_sz) - out_sz / 2
        sample_scale = take(scale_factors, scale_ind)
        translation_vec1 = disp1_mod * disp_to_img * sample_scale
        if not p.advanced_localization:
            return (translation_vec1, scale_ind,
                    torch.zeros((), dtype=torch.int32, device=scores.device), max_score_s)

        sc = take(scores_hn, scale_ind)
        # mask the target neighbourhood (wrap-around distance), second peak
        target_neigh_sz = p.target_neighborhood_scale * state.target_sz / sample_scale * \
            (out_sz / self._support)
        grid = torch.arange(out_sz, dtype=torch.float32, device=scores.device)
        dy = torch.remainder(grid[:, None] - disp1[0] + out_sz / 2, out_sz) - out_sz / 2
        dx = torch.remainder(grid[None, :] - disp1[1] + out_sz / 2, out_sz) - out_sz / 2
        in_neigh = (torch.abs(dy) <= target_neigh_sz[0] / 2 + 0.5) & \
            (torch.abs(dx) <= target_neigh_sz[1] / 2 + 0.5)
        max_score2, max_disp2 = dcf.max2d(torch.where(in_neigh, 0.0, sc))
        disp2_mod = torch.remainder(max_disp2.float() + out_sz / 2, out_sz) - out_sz / 2
        translation_vec2 = disp2_mod * disp_to_img * sample_scale

        disp_norm1 = torch.sqrt(torch.sum(disp1_mod ** 2))
        disp_norm2 = torch.sqrt(torch.sum(disp2_mod ** 2))
        disp_threshold = p.displacement_scale * out_sz / 2

        distractor = max_score2 > p.distractor_threshold * max_score_s
        hn1 = distractor & (disp_norm2 > disp_threshold) & (disp_norm1 < disp_threshold)
        hn2 = distractor & (disp_norm2 < disp_threshold) & (disp_norm1 > disp_threshold)
        uncertain_both = distractor & ~hn1 & ~hn2
        hard_neg2 = (~distractor & (max_score2 > p.hard_negative_threshold * max_score_s)
                     & (max_score2 > p.target_not_found_threshold))

        flag = torch.zeros((), dtype=torch.int32, device=scores.device)
        trans = translation_vec1
        flag = torch.where(hard_neg2, FLAG_HARD_NEG, flag)
        flag = torch.where(uncertain_both, FLAG_UNCERTAIN, flag)
        flag = torch.where(hn2, FLAG_HARD_NEG, flag)
        trans = torch.where(hn2, translation_vec2, trans)
        flag = torch.where(hn1, FLAG_HARD_NEG, flag)
        trans = torch.where(hn1, translation_vec1, trans)
        not_found = max_score_s < p.target_not_found_threshold
        flag = torch.where(not_found, FLAG_NOT_FOUND, flag)
        trans = torch.where(not_found, translation_vec1, trans)
        return trans, scale_ind, flag, max_score_s

    # ---------------------------------------------------------------- memory

    def _update_memory(self, state: ATOMState, sample, y, lr, do_update) -> ATOMState:
        """Weighted-replacement memory update, masked by `do_update`: the new
        sample takes the next free slot, else the lightest slot after the
        initial ones; the initial samples keep `init_samples_minimum_weight`
        together."""
        p = self.params
        M = p.sample_memory_size
        sw = state.mem_weights
        num_init = state.num_init
        num_stored = state.num_stored
        init_w = p.init_samples_minimum_weight

        idx = torch.arange(M, device=self.device)
        s_ind = num_init if init_w > 0 else 0
        r_ind_full = torch.argmin(torch.where(idx >= s_ind, sw, math.inf))
        r_ind = torch.where(num_stored < M, num_stored.long(), r_ind_full)

        prev = state.prev_ind
        sw_new = torch.where(prev < 0, sw / (1 - lr), sw)
        new_w = torch.where(prev < 0, lr, take(sw, torch.clamp(prev, min=0)) / (1 - lr))
        sw_new = torch.where(idx == r_ind, new_w, sw_new)
        sw_new = sw_new / sw_new.sum()
        if init_w > 0:
            init_mask = idx < num_init
            init_sum = torch.where(init_mask, sw_new, 0.0).sum()
            rest_sum = torch.where(~init_mask, sw_new, 0.0).sum()
            sw_adj = torch.where(init_mask, init_w / torch.clamp(num_init, min=1),
                                 sw_new / (init_w + rest_sum))
            sw_new = torch.where(init_sum < init_w, sw_adj, sw_new)

        masked_slot_set(state.mem_samples, r_ind, sample, do_update)
        masked_slot_set(state.mem_y, r_ind, y, do_update)
        return dataclasses.replace(
            state,
            mem_weights=torch.where(do_update, sw_new, state.mem_weights),
            num_stored=torch.where(do_update, torch.clamp(num_stored + 1, max=M), num_stored),
            prev_ind=torch.where(do_update, r_ind.to(torch.int32), state.prev_ind))

    def _refit_iterations(self, flag: int, frame_num: int) -> int:
        """CG iterations of this frame's refit: the hard-negative count on a
        hard negative, else the periodic count every `train_skipping` frames
        (whatever the flag), else none."""
        p = self.params
        if flag == FLAG_HARD_NEG:
            return p.hard_negative_CG_iter
        if (frame_num - 1) % p.train_skipping == 0:
            return p.CG_iter
        return 0

    def _update_filter(self, flag: int) -> None:
        """The refit over the memory, chosen on the host from the read-back
        flag and enqueued after the readback."""
        state = self.state
        num_iter = self._refit_iterations(flag, state.frame_num)
        if num_iter == 0:
            return
        self.state = dataclasses.replace(state, filt=self._filter_cg(
            state.filt, state.mem_samples, state.mem_y, state.mem_weights, num_iter))


def get_tracker_class():
    return ATOMTracker
