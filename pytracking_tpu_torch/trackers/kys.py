"""KYS tracker: DiMP with recurrent scene propagation (counterpart of
pytracking_tpu/trackers/kys.py `KYSParams`, `KYSState`, `KYSTracker`).

Per frame, a dense cost volume between the previous and the current
frame's motion features propagates a state-vector field over the motion
grid; the propagated state is fused with the DiMP score, and the fused
response localises the target. The previous frame's motion features, state
vectors, label and box live in the fixed-shape `KYSState` on the device.
Before the cost volume the previous frame is aligned to the new sample
grid (a centre shift when the target sat off-centre, else the removal of
its sub-pixel offset), once a state exists. Every choice inside the step
is a `torch.where`; the frame's one readback is DiMP's, and the classifier
refit is chosen on the host after it, as in `DiMPTracker`. The step is
written over a leading stream axis (`_step_streams` on a `BatchedKYSState`,
each stream with its own propagation state): the batched server runs B
streams through it, the single tracker one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from pytracking_tpu_torch.models.kys.response_predictor import shift_features
from pytracking_tpu_torch.ops import dcf
from pytracking_tpu_torch.ops.patch import sample_patch
from pytracking_tpu_torch.trackers.base import StreamLayout
from pytracking_tpu_torch.trackers.dimp import (_LEADING_ONE, _MEMORY, _REFINED, FLAG_HARD_NEG,
                                                FLAG_NOT_FOUND, FLAG_UNCERTAIN, BatchedDiMPState,
                                                DiMPParams, DiMPState, DiMPTracker,
                                                _get_iounet_box)


@dataclass(frozen=True)
class KYSParams(DiMPParams):
    """KYS's fields on DiMP's, with the JAX package's defaults."""
    window_output: bool = True
    use_clipped_window: bool = True
    effective_search_area: float = 10.0
    apply_window_to_dimp_score: bool = True
    dimp_threshold: float = 0.05
    target_not_found_threshold_fused: float = 0.05
    prev_feat_remove_subpixel_shift: bool = True
    move_feat_to_center: bool = True
    reset_state_during_occlusion: bool = False
    remove_offset_in_fused_score: bool = True
    output_sigma_factor: float = 1 / 4
    # hard-negative mining on the DiMP score at the fused peak
    perform_hn_mining_dimp: bool = False
    target_neighborhood_scale_safe: float = 2.2


@dataclass
class KYSState(DiMPState):
    motion_feat_prev: torch.Tensor     # (1, C, h, w)
    state_vector: torch.Tensor         # (1, D, h, w)
    prev_label: torch.Tensor           # (1, 1, h, w)
    have_state: torch.Tensor           # () bool: the state vectors are valid
    prev_box_patch: torch.Tensor       # (4,) x, y, w, h in the previous patch


@dataclass
class BatchedKYSState(BatchedDiMPState):
    """`KYSState` of B streams (DiMP's batched layout, the propagation
    state with a leading stream axis)."""
    motion_feat_prev: torch.Tensor     # (B, C, h, w)
    state_vector: torch.Tensor         # (B, D, h, w)
    prev_label: torch.Tensor           # (B, 1, h, w)
    have_state: torch.Tensor           # (B,) bool
    prev_box_patch: torch.Tensor       # (B, 4)


_LAYOUT = StreamLayout(KYSState, BatchedKYSState, _MEMORY,
                       _LEADING_ONE + ("motion_feat_prev", "state_vector", "prev_label"))


class KYSTracker(DiMPTracker):
    """DiMP's tracker with the scene-propagation branch; the step is written
    over a leading stream axis (`_step_streams`), which the batched server
    runs for B streams and the single tracker for one."""

    _layout = _LAYOUT

    def __init__(self, params: KYSParams, net, device="cuda"):
        super().__init__(params, net, device)
        h = self._feature_sz
        eff = int(h * params.effective_search_area / params.search_area_scale)
        self._kys_window = dcf.hann2d_clipped((h, h), (eff, eff), self.device)[None, None] \
            if params.window_output else None
        self._zero_shift = torch.zeros((1, 2), device=self.device)

    # ---------------------------------------------------------------- initialize

    def _init_crop(self, im, bbox, image_sz) -> dict:
        """DiMP's augmentation base patch and the identity sample at the
        (rounded) initial position, which seeds the previous-frame data."""
        p = self.params
        base_patch = super()._init_crop(im, bbox, image_sz)
        pos, _, target_scale = self._target_geometry(bbox)
        s = p.image_sample_size
        patch, coords = sample_patch(im, torch.round(pos), target_scale * self._img_sample_sz,
                                     (s, s), mode=p.border_mode, im_sz=image_sz)
        return {"base_patch": base_patch, "id_patch": patch, "id_coords": coords}

    def _initialize_from_patch(self, crop, bbox, image_sz) -> KYSState:
        state = super()._initialize_from_patch(crop["base_patch"], bbox, image_sz)
        img_sample_sz = self._img_sample_sz
        coords = crop["id_coords"]
        motion_feat = self.net.get_motion_feat(self.net.extract_backbone(crop["id_patch"][None]))
        sample_pos = 0.5 * (coords[:2] + coords[2:])
        sample_scale = torch.sqrt(torch.prod((coords[2:] - coords[:2]) / img_sample_sz))
        label = self._label(state, sample_pos, sample_scale, motion_feat.shape[-2:])
        B, _, h, w = motion_feat.shape
        base = {f.name: getattr(state, f.name) for f in dataclasses.fields(DiMPState)}
        return KYSState(
            **base, motion_feat_prev=motion_feat,
            state_vector=motion_feat.new_zeros((B, self.net.predictor.state_dim, h, w)),
            prev_label=label, have_state=torch.zeros((), dtype=torch.bool, device=self.device),
            prev_box_patch=_get_iounet_box(state.pos, state.target_sz, sample_pos, sample_scale,
                                           img_sample_sz))

    def _label(self, state, sample_pos, sample_scale, hw) -> torch.Tensor:
        """The Gaussian labels (B, 1, h, w) at the targets' positions in the
        samples, half a cell on for an even kernel: `state` brings pos and
        base_target_sz (B, 2), sample_pos is (B, 2), sample_scale (B,); a
        single-stream state's (2,) and () give B = 1."""
        p = self.params
        feat_sz = self._feature_sz
        img_sample_sz = self._img_sample_sz
        sigma = torch.sqrt(torch.prod(feat_sz / img_sample_sz * state.base_target_sz, -1))[
            ..., None] * p.output_sigma_factor * torch.ones(2, device=self.device)
        center = feat_sz * (state.pos - sample_pos) / (sample_scale[..., None] * img_sample_sz) \
            + 0.5 * ((p.kernel_size + 1) % 2)
        return dcf.gauss_2d(tuple(hw), sigma.reshape(-1, 2), center.reshape(-1, 2))[:, None]

    # ---------------------------------------------------------------- track

    def _step_streams(self, state: BatchedKYSState, patch, coords, uniform):
        """One frame of B streams from their search patches (B, 3, s, s) and
        extents (B, 4): (the new state, {'target_bbox' (B, 4), 'max_score'
        (B,), 'flag' (B,)}), all on the device. Each stream's propagation
        state is aligned, propagated and replaced by its own flags; the
        memory is written in place and the filter left as it is (the refit
        follows the readback). `uniform(shape)` returns (B,) + shape U[0, 1)
        draws (the box jitter)."""
        p = self.params
        net = self.net
        img_sample_sz = self._img_sample_sz
        output_sz = float(self._feature_sz)     # displacement cells stride the feature grid
        B = patch.shape[0]
        state = dataclasses.replace(state, frame_num=state.frame_num + 1)

        sample_pos = 0.5 * (coords[:, :2] + coords[:, 2:])
        sample_scale = torch.sqrt(torch.prod((coords[:, 2:] - coords[:, :2]) / img_sample_sz, -1))

        backbone_feat = net.extract_backbone(patch)
        test_x = net.extract_classification_feat(backbone_feat)
        motion_cur = net.get_motion_feat(backbone_feat)
        scores_raw = net.classifier.classify(state.target_filter, test_x)[:, 0]  # (B, Hs, Ws)

        # the even kernel's score map has one more row and column than the
        # motion grid: crop it to the grid
        mh, mw = test_x.shape[-2], test_x.shape[-1]
        dimp_score = scores_raw[:, None, :mh, :mw]                                # (B, 1, h, w)
        window = self._kys_window
        dimp_score_in = dimp_score * window if \
            (window is not None and p.apply_window_to_dimp_score) else dimp_score

        # align each stream's previous frame to its new sample grid: centre
        # the target when it sat far from the previous patch's centre, else
        # remove the sub-pixel part of its position (the cell grid plus the
        # half cell); both only once a state exists
        box_c = state.prev_box_patch[:, :2] + 0.5 * state.prev_box_patch[:, 2:]   # (B, 2) (x, y)
        box_c_max = img_sample_sz[0] * (0.5 + 1.0 / p.search_area_scale)
        box_c_min = img_sample_sz[0] * (0.5 - 1.0 / p.search_area_scale)
        near_center = torch.all((box_c < box_c_max) & (box_c > box_c_min), -1)
        box_c_feat = box_c / 16.0                                                 # (x, y) cells
        s_center = -torch.stack([(box_c_feat[:, 1] - mh * 0.5) / mh,
                                 (box_c_feat[:, 0] - mw * 0.5) / mw], -1)
        box_c_round = torch.round(box_c_feat) + 0.5
        s_sub = torch.stack([(box_c_round[:, 1] - box_c_feat[:, 1]) / (2.0 * mh),
                             (box_c_round[:, 0] - box_c_feat[:, 0]) / (2.0 * mw)], -1)
        no = torch.zeros((B,), dtype=torch.bool, device=self.device)
        use_center = state.have_state & ~near_center if p.move_feat_to_center else no
        use_sub = state.have_state & ~use_center if p.prev_feat_remove_subpixel_shift else no
        s_apply = torch.where(use_center[:, None], s_center,
                              torch.where(use_sub[:, None], s_sub, self._zero_shift))
        motion_prev = shift_features(state.motion_feat_prev, s_apply)
        state_vec_prev = shift_features(state.state_vector, s_apply)

        # before a stream's first found frame its state is seeded from its label
        fused, new_state_vec, _ = net.predict_response(
            motion_prev, motion_cur, state_vec_prev, dimp_score_in, init_label=state.prev_label,
            dimp_thresh=p.dimp_threshold, output_window=window,
            state_valid=state.have_state[:, None, None, None])
        fused = F.relu(fused)[:, 0]

        dimp_win = (dimp_score * window if window is not None else dimp_score)[:, 0]
        translation_vec, flag, max_score = self._localize_fused_streams(
            state, fused, dimp_win, dimp_score[:, 0], sample_pos, sample_scale, output_sz)
        new_pos = sample_pos + translation_vec
        found = flag != FLAG_NOT_FOUND
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

        # the propagation state: replaced only on found frames (kept, or with
        # reset_state_during_occlusion zeroed, on not_found); a state once
        # valid stays valid
        new_label = self._label(state, sample_pos, sample_scale, (mh, mw))
        new_box_patch = _get_iounet_box(state.pos, state.target_sz, sample_pos,
                                        sample_scale[:, None], img_sample_sz)
        found4 = found[:, None, None, None]
        kept_vec = state.state_vector
        if p.reset_state_during_occlusion:
            kept_vec = torch.where(found4, kept_vec, 0.0)
        state = dataclasses.replace(
            state, motion_feat_prev=torch.where(found4, motion_cur, state.motion_feat_prev),
            state_vector=torch.where(found4, new_state_vec, kept_vec),
            prev_label=torch.where(found4, new_label, state.prev_label),
            prev_box_patch=torch.where(found[:, None], new_box_patch, state.prev_box_patch),
            have_state=found | state.have_state, flag=flag, max_score=max_score)
        bbox = torch.cat([state.pos.flip(-1) - (state.target_sz.flip(-1) - 1) / 2,
                          state.target_sz.flip(-1)], -1)
        return state, {"target_bbox": bbox, "max_score": max_score, "flag": flag}

    def _localize_fused_streams(self, state, fused, dimp_win, dimp_raw, sample_pos, sample_scale,
                                output_sz: float):
        """A plain maximum of each stream's fused response (B, h, w) with the
        fused not-found threshold: never `uncertain`, and `hard_negative`
        only through the optional mining on the DiMP score. When the fused
        and the DiMP peaks are exactly one cell apart the DiMP peak wins
        (`remove_offset_in_fused_score`). Returns (translation (B, 2), flag
        (B,) int32, max score (B,))."""
        p = self.params
        img_sample_sz = self._img_sample_sz
        B, h, w = fused.shape
        max1, disp1 = dcf.max2d(fused)
        disp1 = disp1.float()
        if p.remove_offset_in_fused_score:
            _, disp_d = dcf.max2d(dimp_win)
            disp_d = disp_d.float()
            one_off = torch.amax(torch.abs(disp1 - disp_d), -1) == 1.0
            disp1 = torch.where(one_off[:, None], disp_d, disp1)

        score_center = float(output_sz // 2)
        translation_vec = (disp1 - score_center) * (img_sample_sz / output_sz) * \
            sample_scale[:, None]

        not_found = max1 < p.target_not_found_threshold_fused
        flag = torch.zeros((B,), dtype=torch.int32, device=self.device)
        flag = torch.where(not_found, FLAG_NOT_FOUND, flag)

        if p.perform_hn_mining_dimp:
            # the (unwindowed) DiMP score at the fused peak, and its largest
            # value outside the target's integer-rounded neighbourhood
            di = disp1.long()
            s1 = dimp_raw.flatten(1).gather(1, (di[:, 0] * w + di[:, 1])[:, None])[:, 0]
            neigh = (p.target_neighborhood_scale_safe * torch.sqrt(torch.prod(state.target_sz, -1))
                     / sample_scale)[:, None] * (output_sz / img_sample_sz)
            top = torch.clamp(torch.round(disp1[:, 0] - neigh[:, 0] / 2), 0, h)
            bottom = torch.clamp(torch.round(disp1[:, 0] + neigh[:, 0] / 2 + 1), 0, h)
            left = torch.clamp(torch.round(disp1[:, 1] - neigh[:, 1] / 2), 0, w)
            right = torch.clamp(torch.round(disp1[:, 1] + neigh[:, 1] / 2 + 1), 0, w)
            iy = torch.arange(h, dtype=torch.float32, device=self.device)[None, :, None]
            ix = torch.arange(w, dtype=torch.float32, device=self.device)[None, None, :]
            in_neigh = ((iy >= top[:, None, None]) & (iy < bottom[:, None, None])
                        & (ix >= left[:, None, None]) & (ix < right[:, None, None]))
            max2, _ = dcf.max2d(torch.where(in_neigh, 0.0, dimp_raw))
            hn = (max2 > p.hard_negative_threshold * s1) & (max2 > 0.1) & ~not_found
            flag = torch.where(hn, FLAG_HARD_NEG, flag)
        return translation_vec, flag, max1


def get_tracker_class():
    return KYSTracker
