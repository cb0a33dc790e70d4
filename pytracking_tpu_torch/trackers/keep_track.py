"""KeepTrack tracker: SuperDiMP with learned association of target candidates
across frames (counterpart of pytracking_tpu/trackers/keep_track.py
`KeepTrackParams`, `KeepTrackState`, `Candidate`, `CandidateCollection`,
`KeepTrackTracker`).

A frame runs in three parts. Part 1: DiMP's classification and
localisation, the top-K local maxima of the score map as candidates (a 5x5
max-pool NMS over fixed K slots with a validity mask), their descriptors
from the matching net's own backbone, and the SuperGlue / Sinkhorn match
against the previous frame's candidates. The association: which candidate
continues the target, by `CandidateCollection`'s rules. Part 2: the
position update, the search-area rescaling after a lost target, the box
refinement and the certainty-weighted memory update.

With `device_association` (the default) the association runs on the
device over the K slots (`_associate_device`), so the whole step is one
sequence of device work with one readback: box, flag, candidate score,
object presence and part 1's score peak, the certainty that gates the
classifier refit; the refit is chosen on the host after the readback, as
in `DiMPTracker`. Without it, part 1's candidate arrays are read back and
the host's `CandidateCollection` chooses (the reference's split, two
readbacks per frame); the tests hold the device association to it.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pytracking_tpu_torch.trackers.base import masked_slot_set, take
from pytracking_tpu_torch.trackers.dimp import (FLAG_HARD_NEG, FLAG_NAMES, FLAG_NORMAL,
                                                FLAG_NOT_FOUND, FLAG_UNCERTAIN, DiMPParams,
                                                DiMPState, DiMPTracker, _get_iounet_box)
from pytracking_tpu_torch.utils.device import ieee_float32

SCALE_HISTORY = 60


@dataclass(frozen=True)
class KeepTrackParams(DiMPParams):
    """KeepTrack's fields on DiMP's, with the JAX package's defaults."""
    image_sample_size: int = 30 * 16
    search_area_scale: float = 8.0
    border_mode: str = "inside_major"
    patch_max_scale_change: Optional[float] = 1.5
    box_refinement_space: str = "relative"
    box_refinement_iter: int = 10
    box_refinement_step_length: float = 2.5e-3
    local_max_candidate_score_th: float = 0.05
    max_candidates: int = 10
    use_certainty_for_weight_computation: bool = True
    certainty_for_weight_computation_ths: float = 0.5


@dataclass
class KeepTrackState(DiMPState):
    prev_cand_desc: torch.Tensor           # (K, D)
    prev_cand_img_coords: torch.Tensor     # (K, 2) x, y in patch pixels
    prev_cand_scores: torch.Tensor         # (K,)
    prev_cand_valid: torch.Tensor          # (K,) bool
    prev_cand_frame: int                   # host frame count of the stored candidates
    mem_certainties: torch.Tensor          # (M,) the label certainty of each slot
    target_not_found_counter: torch.Tensor  # () int32
    scale_history: torch.Tensor            # (60,) oldest first, newest last
    scale_history_n: torch.Tensor          # () int32, valid entries
    # the association over K fixed slots (`_associate_device`)
    assoc_object_ids: torch.Tensor         # (K,) int32, -1 = empty slot
    assoc_hist_scores: torch.Tensor        # (K,) running max score per track
    assoc_selected_oid: torch.Tensor       # () int32
    assoc_certain: torch.Tensor            # () bool
    assoc_flag: torch.Tensor               # () int32
    assoc_id_cntr: torch.Tensor            # () int32
    assoc_active: torch.Tensor             # () bool


class Candidate:
    def __init__(self, cid, score, coord, object_id):
        self.ids = [cid]
        self.scores = [score]
        self.coords = [coord]
        self.object_id = object_id


class CandidateCollection:
    """The association's bookkeeping on the host: object ids carried along
    the matches, and the rules that keep, drop or reselect the target."""

    def __init__(self, scores, coords, candidate_selection_is_certain=True):
        self.candidates = {}
        self.object_id_cntr = 0
        self.flag = "normal"
        self.candidate_id_of_selected_candidate = 0
        self.object_id_of_selected_candidate = 0
        self.candidate_selection_is_certain = candidate_selection_is_certain
        if not candidate_selection_is_certain:
            self.object_id_of_selected_candidate = 1
            self.object_id_cntr = 1
        for cid, (score, coord) in enumerate(zip(scores, coords)):
            self.candidates[cid] = Candidate(cid, score, coord, self.object_id_cntr)
            self.object_id_cntr += 1

    def update(self, scores, coords, matches, match_scores):
        self._reassign(match_scores, matches, scores, coords)
        detected = self._check_object0_detected()
        detected = self._check_more_suitable(detected)
        if not detected:
            self._cleanup_not_found()
            self._reselect()

    def _reassign(self, match_scores, matches, scores, coords):
        candidates = {}
        for cid, (score, coord, match, mscore) in enumerate(
                zip(scores, coords, matches, match_scores)):
            if match >= 0 and match in self.candidates:
                candidate = self.candidates[match]
                low_prob = mscore < 0.6 or (mscore < 0.85 and score < 0.2)
                if candidate.object_id == self.object_id_of_selected_candidate and low_prob:
                    candidate = Candidate(cid, score, coord, self.object_id_cntr)
                    self.object_id_cntr += 1
                else:
                    candidate.scores.append(score)
                    candidate.ids.append(cid)
                    candidate.coords.append(coord)
                candidates[cid] = candidate
            else:
                candidates[cid] = Candidate(cid, score, coord, self.object_id_cntr)
                self.object_id_cntr += 1
        self.candidates = candidates

    def _check_object0_detected(self):
        detected = False
        for cid, c in self.candidates.items():
            if c.object_id == self.object_id_of_selected_candidate:
                self.candidate_id_of_selected_candidate = cid
                self.flag = "normal"
                detected = True
                if max(c.scores) > 0.75:
                    self.candidate_selection_is_certain = True
        return detected

    def _check_more_suitable(self, detected):
        if detected and self.candidate_id_of_selected_candidate != 0 and 0 in self.candidates:
            best = self.candidates[0]
            cur = self.candidates[self.candidate_id_of_selected_candidate]
            if max(best.scores) > max(cur.scores):
                self.flag = "normal"
                self.candidate_id_of_selected_candidate = 0
                self.object_id_of_selected_candidate = best.object_id
        return detected

    def _cleanup_not_found(self):
        self.candidate_id_of_selected_candidate = None
        if self.flag == "normal":
            self.flag = "not_found"
            self.candidate_selection_is_certain = False

    def _reselect(self):
        max_score = 0.0
        for cid, c in self.candidates.items():
            recent = c.scores[-1]
            if recent > 0.25 and recent > max_score:
                self.flag = "normal"
                self.candidate_id_of_selected_candidate = cid
                self.object_id_of_selected_candidate = c.object_id
                max_score = recent


def top_k_peaks(scores: torch.Tensor, k: int, threshold: float):
    """The K highest local maxima of a (H, W) map above `threshold` (5x5
    max-pool NMS): (scores (K,), (row, col) cells (K, 2) float, valid (K,)).
    Slots past the last peak are invalid, with score 0 and the cells of the
    lowest flat indices; ties go to the lower flat index (a stable sort of
    the flat map), as `lax.top_k` orders them."""
    w = scores.shape[-1]
    pooled = F.max_pool2d(scores[None, None], 5, stride=1, padding=2)[0, 0]
    peak = (scores == pooled) & (scores > threshold)
    flat = torch.where(peak.reshape(-1), scores.reshape(-1), -math.inf)
    top_v, top_i = torch.sort(flat, descending=True, stable=True)
    top_v, top_i = top_v[:k], top_i[:k]
    valid = torch.isfinite(top_v)
    coords = torch.stack([top_i // w, top_i % w], dim=-1).float()
    return torch.where(valid, top_v, 0.0), coords, valid


class KeepTrackTracker(DiMPTracker):
    """`tcm_net`: the target candidate matching net."""

    # the certainty-weighted refit does not honour defer_classifier_update
    supports_deferred_classifier_update = False

    def __init__(self, params: KeepTrackParams, net, tcm_net, device="cuda",
                 device_association: bool = True):
        super().__init__(params, net, device)
        self.tcm_net = tcm_net.to(self.device).eval().requires_grad_(False)
        self.device_association = device_association
        self.candidate_collection: Optional[CandidateCollection] = None

    # ---------------------------------------------------------------- host API

    @torch.no_grad()
    @ieee_float32()
    def initialize(self, image, info: Dict[str, Any]) -> dict:
        out = super().initialize(image, info)
        p = self.params
        K, M = p.max_candidates, p.sample_memory_size
        D = self.tcm_net.descriptor_extractor.descriptor_dim
        dev = self.device

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        base = {f.name: getattr(self.state, f.name) for f in dataclasses.fields(DiMPState)}
        self.state = KeepTrackState(
            **base, prev_cand_desc=torch.zeros((K, D), device=dev),
            prev_cand_img_coords=torch.zeros((K, 2), device=dev),
            prev_cand_scores=torch.zeros((K,), device=dev),
            prev_cand_valid=torch.zeros((K,), dtype=torch.bool, device=dev),
            prev_cand_frame=-10,
            # the initial samples carry certainty 1
            mem_certainties=(torch.arange(M, device=dev) < base["num_stored"]).float(),
            target_not_found_counter=i32(0),
            scale_history=torch.zeros((SCALE_HISTORY,), device=dev), scale_history_n=i32(0),
            assoc_object_ids=torch.full((K,), -1, dtype=torch.int32, device=dev),
            assoc_hist_scores=torch.zeros((K,), device=dev), assoc_selected_oid=i32(0),
            assoc_certain=torch.ones((), dtype=torch.bool, device=dev),
            assoc_flag=i32(FLAG_NORMAL), assoc_id_cntr=i32(0),
            assoc_active=torch.zeros((), dtype=torch.bool, device=dev))
        self.candidate_collection = None
        return out

    @torch.no_grad()
    @ieee_float32()
    def track(self, image, info: Optional[dict] = None) -> dict:
        im = self._image_tensor(image)
        patch, coords = self._track_crop(self.state, im)
        if not self.device_association:
            return self._track_split(patch, coords)
        self.state, out = self._track_from_patch(self.state, patch, coords)
        host = torch.cat([out["target_bbox"], out["max_score"][None], out["flag"][None].float(),
                          out["object_presence_score"][None],
                          out["certainty"][None]]).cpu().numpy()        # the one sync
        return self._finish(host)

    def _finish(self, host) -> dict:
        """The host's part of a frame after its readback (box, score, flag,
        presence, certainty): the classifier refit and the output dict."""
        flag = int(host[5])
        self._update_classifier_certainty(flag, float(host[7]))
        bbox = host[:4].tolist()
        if self.params.output_not_found_box and flag == FLAG_NOT_FOUND:
            bbox = [-1, -1, -1, -1]
        return {"target_bbox": bbox, "max_score": float(host[4]),
                "object_presence_score": float(host[6]), "flag": FLAG_NAMES[flag]}

    def _track_split(self, patch, coords) -> dict:
        """Part 1, the host's `CandidateCollection`, part 2."""
        state, p1 = self._track_part1_from_patch(self.state, patch, coords)
        host = {k: p1[k].cpu().numpy() for k in ("cand_scores", "cand_coords", "cand_valid",
                                                 "matches", "match_scores", "max_score")}
        cid, flag, is_object0 = self._associate_host(host, state.frame_num,
                                                     p1["prev_frame_gap"])
        sel_coord, cand_score = p1["default_disp"], p1["max_score"]
        if cid is not None:
            sel_coord, cand_score = p1["cand_coords"][cid], p1["cand_scores"][cid]

        def dev(v, dtype):
            return torch.as_tensor(v, dtype=dtype, device=self.device)

        self.state, out = self._track_part2(
            state, p1, sel_coord, dev(cid is not None, torch.bool),
            p1["default_flag"] if flag is None else dev(flag, torch.int32), cand_score,
            p1["max_score"], dev(is_object0, torch.bool))
        max_score1 = float(host["max_score"])
        presence = max(max_score1, math.sqrt(max(max_score1, 0.0))) if is_object0 else \
            max_score1
        host = torch.cat([out["target_bbox"], out["max_score"][None],
                          out["flag"][None].float()]).cpu().numpy()
        return self._finish(np.concatenate([host, [presence, max_score1]]))

    def _associate_host(self, host: dict, frame_num: int, prev_frame_gap: int):
        """The association by `CandidateCollection` on part 1's read-back
        candidate arrays (`host`, numpy). Returns (the selected candidate's
        slot, or None for DiMP's localisation; the flag, or None for DiMP's;
        whether the selection is object 0)."""
        p = self.params
        K = int(host["cand_valid"].sum())
        scores = host["cand_scores"][:K].tolist()
        coords = [host["cand_coords"][i] for i in range(K)]
        use_matching = float(host["max_score"]) >= p.local_max_candidate_score_th and K > 0
        cid, flag = None, None
        if not use_matching or prev_frame_gap > 1 or self.candidate_collection is None:
            self.candidate_collection = CandidateCollection(
                scores, coords, candidate_selection_is_certain=frame_num < 10) \
                if use_matching else None
        else:
            cc = self.candidate_collection
            cc.update(scores, coords, host["matches"][:K].tolist(),
                      host["match_scores"][:K].tolist())
            cid = cc.candidate_id_of_selected_candidate
            flag = FLAG_NOT_FOUND if cid is None else \
                {"normal": FLAG_NORMAL, "not_found": FLAG_NOT_FOUND}[cc.flag]
        is_object0 = (self.candidate_collection is None
                      or self.candidate_collection.object_id_of_selected_candidate == 0)
        return cid, flag, is_object0

    # ---------------------------------------------------------------- part 1

    def _track_part1_from_patch(self, state: KeepTrackState, patch, coords):
        p = self.params
        net = self.net
        img_sample_sz = self._img_sample_sz
        K = p.max_candidates
        state = dataclasses.replace(state, frame_num=state.frame_num + 1)
        sample_pos = 0.5 * (coords[:2] + coords[2:])
        sample_scale = torch.sqrt(torch.prod((coords[2:] - coords[:2]) / img_sample_sz))

        backbone_feat = net.extract_backbone(patch[None])
        test_x = net.extract_classification_feat(backbone_feat)
        scores = net.classifier.classify(state.target_filter, test_x)[0, 0]
        # DiMP's localisation, used when the matching is skipped
        trans_default, flag_default, max_score = self._localize(state, scores, sample_pos,
                                                                sample_scale)

        cand_scores, cand_coords, cand_valid = top_k_peaks(scores, K,
                                                           p.local_max_candidate_score_th)
        tcm_feat = self.tcm_net.extract_backbone(patch[None])
        desc = self.tcm_net.get_descriptors(tcm_feat, cand_coords[None].long())[0]

        # (x, y) patch pixels of the cells' centres
        stride = float(p.feature_stride)
        img_coords = torch.stack([cand_coords[:, 1] * stride + stride / 2,
                                  cand_coords[:, 0] * stride + stride / 2], dim=-1)
        pred = self.tcm_net.match(state.prev_cand_img_coords[None], img_coords[None],
                                  state.prev_cand_desc[None], desc[None],
                                  state.prev_cand_scores[None], cand_scores[None],
                                  state.prev_cand_valid[None], cand_valid[None])
        # each current candidate's best previous one, or none where the
        # dustbin is likelier
        col = torch.exp(pred["log_assignment"][0])[:, :K]                # (K + 1, K)
        best_prob, best_prev = torch.max(col[:K], dim=0)
        matches = torch.where(best_prob > col[K], best_prev, -1)

        p1 = {"cand_scores": cand_scores, "cand_coords": cand_coords, "cand_valid": cand_valid,
              "matches": matches, "match_scores": best_prob, "max_score": max_score,
              "default_disp": trans_default, "default_flag": flag_default,
              "prev_frame_gap": state.frame_num - state.prev_cand_frame,
              "backbone_feat": backbone_feat, "test_x": test_x, "sample_pos": sample_pos,
              "sample_scale": sample_scale}
        state = dataclasses.replace(state, prev_cand_desc=desc, prev_cand_img_coords=img_coords,
                                    prev_cand_scores=cand_scores, prev_cand_valid=cand_valid,
                                    prev_cand_frame=state.frame_num)
        return state, p1

    # ---------------------------------------------------------------- association

    def _associate_device(self, state: KeepTrackState, p1):
        """`CandidateCollection`'s rules as tensor ops over the K fixed
        slots. Returns (state, selected coordinate, whether it is a
        candidate's cell, flag, candidate score, whether the selection is
        object 0)."""
        p = self.params
        K = p.max_candidates
        dev = self.device
        idxs = torch.arange(K, device=dev)
        cand_scores, cand_valid = p1["cand_scores"], p1["cand_valid"]
        matches, match_scores = p1["matches"], p1["match_scores"]
        max_score = p1["max_score"]
        n_valid = cand_valid.sum().to(torch.int32)

        use_matching = (max_score >= p.local_max_candidate_score_th) & (n_valid > 0)
        do_update = use_matching & state.assoc_active if p1["prev_frame_gap"] <= 1 \
            else torch.zeros_like(use_matching)
        do_create = use_matching & ~do_update

        # constants are Python scalars: a host tensor copied up mid-frame
        # would synchronise
        NORMAL, NOT_FOUND = FLAG_NORMAL, FLAG_NOT_FOUND

        # create: ids from 0 when the selection is certain, else from 1;
        # slot 0 (the highest score) is selected
        cr_certain = state.frame_num < 10
        offset = 0 if cr_certain else 1
        cr_ids = torch.where(cand_valid, idxs + offset, -1).to(torch.int32)
        cr_hist = torch.where(cand_valid, cand_scores, 0.0)
        cr_sel_oid = offset
        cr_id_cntr = offset + n_valid

        # update: inherit the matched previous slot's object, or a new id
        prev_ids, prev_hist = state.assoc_object_ids, state.assoc_hist_scores
        sel_oid = state.assoc_selected_oid
        m_safe = torch.clamp(matches, min=0)
        inh_oid = prev_ids[m_safe]
        matched = cand_valid & (matches >= 0) & (inh_oid >= 0)
        low_prob = (match_scores < 0.6) | ((match_scores < 0.85) & (cand_scores < 0.2))
        steal = matched & (inh_oid == sel_oid) & low_prob
        new_needed = cand_valid & (~matched | steal)
        new_i = new_needed.to(torch.int32)
        new_ids = state.assoc_id_cntr + torch.cumsum(new_i, 0).to(torch.int32) - new_i
        up_ids = torch.where(cand_valid, torch.where(new_needed, new_ids, inh_oid),
                             -1).to(torch.int32)
        # slots that inherit one object share its score history; the most
        # recent score of the object is its last slot's
        keep = matched & ~steal
        grp = keep[:, None] & keep[None, :] & (inh_oid[:, None] == inh_oid[None, :])
        shared_max = torch.where(grp, cand_scores[None, :], -math.inf).amax(dim=1)
        last_sharer = torch.where(grp, idxs[None, :], -1).amax(dim=1)
        recent = torch.where(keep, cand_scores[torch.clamp(last_sharer, min=0)], cand_scores)
        up_hist = torch.where(keep, torch.maximum(prev_hist[m_safe], shared_max), cand_scores)
        up_hist = torch.where(cand_valid, up_hist, 0.0)
        up_id_cntr = state.assoc_id_cntr + new_i.sum().to(torch.int32)

        # the selected object detected: its last slot
        matchmask = cand_valid & (up_ids == sel_oid)
        detected = matchmask.any()
        sel_cid_det = torch.where(matchmask, idxs, -1).amax().to(torch.int32)
        certain_det = state.assoc_certain | (matchmask & (up_hist > 0.75)).any()
        # slot 0 with a higher history takes over
        sel_safe = torch.clamp(sel_cid_det, min=0).long()
        better0 = detected & (sel_cid_det != 0) & cand_valid[0] & \
            (up_hist[0] > take(up_hist, sel_safe))
        sel_cid_det = torch.where(better0, 0, sel_cid_det)
        sel_oid_det = torch.where(better0, up_ids[0], sel_oid)

        # not detected: lost, then reselect on each object's recent score
        flag_nf0 = torch.where(state.assoc_flag == NORMAL, NOT_FOUND, state.assoc_flag)
        recent_ok = cand_valid & (recent > 0.25)
        any_ok = recent_ok.any()
        best = torch.argmax(torch.where(recent_ok, recent, -math.inf)).to(torch.int32)
        sel_cid_nf = torch.where(any_ok, best, -1)
        sel_oid_nf = torch.where(any_ok, take(up_ids, best), sel_oid)
        flag_nf = torch.where(any_ok, NORMAL, flag_nf0)

        up_sel_cid = torch.where(detected, sel_cid_det, sel_cid_nf)
        up_sel_oid = torch.where(detected, sel_oid_det, sel_oid_nf)
        up_flag = torch.where(detected, NORMAL, flag_nf)
        up_certain = detected & certain_det

        def pick(cr, up, prev):
            return torch.where(do_create, cr, torch.where(do_update, up, prev))

        state = dataclasses.replace(
            state, assoc_object_ids=pick(cr_ids, up_ids, state.assoc_object_ids),
            assoc_hist_scores=pick(cr_hist, up_hist, state.assoc_hist_scores),
            assoc_selected_oid=pick(cr_sel_oid, up_sel_oid, state.assoc_selected_oid),
            assoc_certain=pick(cr_certain, up_certain, state.assoc_certain),
            assoc_flag=pick(NORMAL, up_flag, state.assoc_flag),
            assoc_id_cntr=pick(cr_id_cntr, up_id_cntr, state.assoc_id_cntr),
            assoc_active=use_matching)

        has_cand = do_update & (up_sel_cid >= 0)
        sel = torch.clamp(up_sel_cid, min=0).long()
        sel_coord = torch.where(has_cand, take(p1["cand_coords"], sel), p1["default_disp"])
        flag = torch.where(has_cand, up_flag,
                           torch.where(do_update, NOT_FOUND, p1["default_flag"]))
        cand_score = torch.where(has_cand, take(cand_scores, sel), max_score)
        is_object0 = ~use_matching | (state.assoc_selected_oid == 0)
        return state, sel_coord, has_cand, flag, cand_score, is_object0

    # ---------------------------------------------------------------- the step

    def _track_from_patch(self, state: KeepTrackState, patch, coords):
        """Part 1, the device association and part 2."""
        state, p1 = self._track_part1_from_patch(state, patch, coords)
        state, sel_coord, sel_is_grid, flag, cand_score, is_object0 = \
            self._associate_device(state, p1)
        state, out = self._track_part2(state, p1, sel_coord, sel_is_grid, flag, cand_score,
                                       p1["max_score"], is_object0)
        m = p1["max_score"]
        out["object_presence_score"] = torch.where(
            is_object0, torch.maximum(m, torch.sqrt(torch.clamp(m, min=0.0))), m)
        out["certainty"] = m
        return state, out

    # ---------------------------------------------------------------- part 2

    def _track_part2(self, state: KeepTrackState, p1, sel_coord, sel_is_grid, flag, cand_score,
                     certainty, is_object0):
        """`sel_coord`: a candidate's (row, col) cell when `sel_is_grid`,
        else the image translation of DiMP's localisation."""
        p = self.params
        img_sample_sz = self._img_sample_sz
        sample_pos, sample_scale = p1["sample_pos"], p1["sample_scale"]
        output_sz = float(self._feature_sz)     # score cells stride the feature grid
        disp_from_grid = (sel_coord - self._score_center) * (img_sample_sz / output_sz) * \
            sample_scale
        new_pos = sample_pos + torch.where(sel_is_grid, disp_from_grid, sel_coord)
        found = flag != FLAG_NOT_FOUND
        inside_offset = (p.target_inside_ratio - 0.5) * state.target_sz
        clamped = torch.maximum(torch.minimum(new_pos, state.image_sz - inside_offset),
                                inside_offset)
        state = dataclasses.replace(state, pos=torch.where(found, clamped, state.pos))
        state = self._rescale_search_area(state, found)

        if p.use_iou_net:
            update_scale = True if p.update_scale_when_uncertain else flag != FLAG_UNCERTAIN
            state = self._refine_target_box(state, p1["backbone_feat"], sample_pos, sample_scale,
                                            found, update_scale)

        if p.update_classifier:
            update_flag = (flag != FLAG_NOT_FOUND) & (flag != FLAG_UNCERTAIN)
            target_box = _get_iounet_box(state.pos, state.target_sz, sample_pos, sample_scale,
                                         img_sample_sz)
            lr = torch.where(flag == FLAG_HARD_NEG, p.hard_negative_learning_rate,
                             p.learning_rate)
            # object-0 selections store a certainty raised by a square root
            cert_store = torch.where(is_object0, torch.maximum(
                certainty, torch.sqrt(torch.clamp(certainty, min=0.0))), certainty)
            state = self._update_memory_certainty(state, p1["test_x"][0], target_box, lr,
                                                  update_flag, cert_store)

        state = dataclasses.replace(state, flag=flag, max_score=cand_score)
        bbox = torch.cat([state.pos.flip(-1) - (state.target_sz.flip(-1) - 1) / 2,
                          state.target_sz.flip(-1)])
        return state, {"target_bbox": bbox, "max_score": cand_score, "flag": flag}

    def _rescale_search_area(self, state: KeepTrackState, found) -> KeepTrackState:
        """A found frame appends the (pre-refinement) scale to the history,
        newest last, and resets the lost counter. A lost frame sets the scale
        to the mean of the newest `num_scales` entries at least as large as
        the newest one, `num_scales` growing with consecutive lost frames
        (2 to 30)."""
        hist, n = state.scale_history, state.scale_history_n
        pushed = torch.cat([hist[1:], state.target_scale.reshape(1)])
        counter = state.target_not_found_counter + 1
        num_scales = torch.clamp(counter, 2, 30)
        valid = torch.arange(SCALE_HISTORY, device=self.device) >= SCALE_HISTORY - n
        kept = valid & (hist >= hist[-1])
        rev_rank = torch.cumsum(kept.flip(0).to(torch.int32), 0).flip(0)
        sel = kept & (rev_rank <= num_scales)
        mean = torch.where(sel, hist, 0.0).sum() / torch.clamp(sel.sum(), min=1)
        lost_scale = torch.where(n > 0, mean, state.target_scale)
        return dataclasses.replace(
            state, scale_history=torch.where(found, pushed, hist),
            scale_history_n=torch.where(found, torch.clamp(n + 1, max=SCALE_HISTORY), n),
            target_not_found_counter=torch.where(found, torch.zeros_like(counter), counter),
            target_scale=torch.where(found, state.target_scale, lost_scale))

    # ---------------------------------------------------------------- memory

    def _update_memory_certainty(self, state: KeepTrackState, sample, target_box, lr,
                                 do_update, cert_store) -> KeepTrackState:
        """DiMP's weighted-replacement update, replacing the slot with the
        least certainty x weight, and the slot's certainty written beside
        it."""
        key = state.mem_certainties * state.mem_weights \
            if self.params.use_certainty_for_weight_computation else None
        state = self._update_memory_masked(state, sample, target_box, lr, do_update,
                                           replace_key=key)
        # where it updates, the update wrote the replaced slot to prev_ind
        masked_slot_set(state.mem_certainties, torch.clamp(state.prev_ind, min=0).long(),
                        cert_store, do_update)
        return state

    def _update_classifier_certainty(self, flag: int, certainty: float) -> None:
        """The refit over the memory, chosen on the host after the readback:
        the hard-negative count on a hard negative whose certainty reaches
        the threshold, else the periodic count every `train_skipping`
        frames; slots whose certainty is below the threshold weigh
        nothing."""
        p = self.params
        if not p.update_classifier:
            return
        num_iter = self._classifier_iterations_certainty(flag, self.state.frame_num, certainty)
        if num_iter == 0:
            return
        state = self.state
        weights = state.mem_weights
        if p.use_certainty_for_weight_computation:
            ths = p.certainty_for_weight_computation_ths
            cert = state.mem_certainties
            weights = weights * torch.where(cert >= ths, cert, 0.0)
        new_filter = self.net.classifier.filter_optimizer(
            state.target_filter, state.mem_samples[:, None], state.mem_boxes[:, None],
            sample_weight=weights[:, None], num_iter=num_iter)
        self.state = dataclasses.replace(state, target_filter=new_filter)

    def _classifier_iterations_certainty(self, flag: int, frame_num: int,
                                         certainty: float) -> int:
        p = self.params
        update = flag not in (FLAG_NOT_FOUND, FLAG_UNCERTAIN)
        hn_ok = certainty >= p.certainty_for_weight_computation_ths \
            if p.use_certainty_for_weight_computation else True
        if update and flag == FLAG_HARD_NEG and hn_ok:
            return p.net_opt_hn_iter
        if update and (frame_num - 1) % p.train_skipping == 0:
            return p.net_opt_update_iter
        return 0


def get_tracker_class():
    return KeepTrackTracker
