"""ECO tracker: factorised correlation filters learned in the Fourier domain
(counterpart of pytracking_tpu/trackers/eco.py `ECOParams`, `ECOTracker`).

Two feature blocks (ResNet18-VGG-m1's 'vggconv1' pooled to stride 4 and
'layer3' at stride 16 by default), each power-normalised, Hann-windowed,
transformed to a centred complex64 spectrum (NCHW: the FFT runs over the
last two dims, H and W), zero-padded to the odd filter grid and multiplied
by the bicubic interpolation kernel. Per block the variables are a Fourier
filter hf (c, fh, fw) and a projection P (Cin, c). The first frame fits
{hf, P} jointly by Gauss-Newton/CG from P's PCA init (an SVD of the channel
covariance, on the device, in `initialize` only) with ECO's diagonal
preconditioner; the data residual is the projected samples times hf minus
the Gaussian label's spectrum, the regulariser the spatial filter times
the polynomial window. Every frame scores 5 scales: each block's spectrum
summed over channels, weighted, zero-padded to a common grid, sampled on
the sample's pixel grid; the best scale's wrap-around argmax moves the
target. The frame's projected spectra, shifted to centre the target, enter
a memory of `sample_memory_size` slots by minimum weight. Every
`train_skipping` frames (a host count) the filter alone is refitted by one
Gauss-Newton step of `CG_iter` CG iterations over the memory, enqueued
after the frame's readback.

The dropout masks come from a `torch.Generator` seeded at `initialize`,
through `_keep_mask`; the augmentation list is fixed (no random shift).
Singular vectors are unique up to sign: the fit and the scores are
invariant under flipping a column of P with the matching channel of hf.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytracking_tpu_torch.ops import augmentation as aug
from pytracking_tpu_torch.ops import dcf, fourier, solvers
from pytracking_tpu_torch.ops.patch import sample_patch
from pytracking_tpu_torch.trackers.base import BaseTracker, take
from pytracking_tpu_torch.utils.device import ieee_float32


@dataclass(frozen=True)
class ECOParams:
    """Static tracker configuration: the JAX package's fields and defaults
    (ECO's `default` parameters)."""
    max_image_sample_size: int = 250 ** 2
    min_image_sample_size: int = 200 ** 2
    search_area_scale: float = 4.5
    # optimisation
    CG_iter: int = 5
    init_CG_iter: int = 100
    init_GN_iter: int = 10
    post_init_CG_iter: int = 0
    projection_reg: float = 5e-8
    precond_data_param: float = 0.3
    precond_reg_param: float = 0.15
    precond_proj_param: float = 35.0
    # learning
    learning_rate: float = 0.0075
    sample_memory_size: int = 200
    train_skipping: int = 10
    # per block: (stride, compressed_dim, output_sigma_factor,
    # translation_weight, reg_window_edge)
    blocks: tuple = ((4, 16, 1 / 16, 0.4, 10e-3), (16, 64, 1 / 4, 0.6, 50e-3))
    # backbone outputs read per block: (layer name, average-pool stride)
    feature_blocks: tuple = (("vggconv1", 2), ("layer3", 1))
    normalize_power: Optional[int] = 2
    reg_window_min: float = 1e-4
    reg_window_power: int = 2
    # detection
    scale_factors: Tuple[float, ...] = tuple(float(1.02 ** x) for x in range(-2, 3))
    score_upsample_factor: int = 1
    border_mode: str = "replicate"
    # init augmentation
    use_augmentation: bool = True
    augmentation: tuple = (("fliplr", True),
                           ("rotate", (5, -5, 10, -10, 20, -20, 30, -30, 45, -45,
                                       -60, 60)),
                           ("blur", ((2, 0.2), (0.2, 2), (3, 1), (1, 3), (2, 2))),
                           ("shift", ((6, 6), (-6, 6), (6, -6), (-6, -6))),
                           ("dropout", (7, 0.2)))
    augmentation_expansion_factor: float = 2.0
    target_inside_ratio: float = 0.2

    def aug_dict(self) -> dict:
        return dict(self.augmentation) if self.use_augmentation else {}


@dataclass
class ECOState:
    pos: torch.Tensor                     # (2,) (y, x)
    target_sz: torch.Tensor               # (2,) (h, w)
    target_scale: torch.Tensor            # ()
    base_target_sz: torch.Tensor          # (2,)
    image_sz: torch.Tensor                # (2,) (H, W)
    min_scale: torch.Tensor               # ()
    max_scale: torch.Tensor               # ()
    filters: List[torch.Tensor]           # per block (c, fh, fw) complex64
    proj: List[torch.Tensor]              # per block (Cin, c)
    samples_f: List[torch.Tensor]         # per block (M, c, fh, fw) complex64
    sample_energy: List[torch.Tensor]     # per block (c, fh, fw)
    sample_weights: torch.Tensor          # (M,)
    num_stored: torch.Tensor              # () int32
    prev_ind: torch.Tensor                # () int32, -1 = none
    frame_num: int                        # host count: 1 after initialize
    scale_ind: torch.Tensor               # () the last frame's scale index
    max_score: torch.Tensor               # ()


def _project(xf: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Spectra (..., Cin, h, w) projected by P (Cin, c): (..., c, h, w)."""
    return torch.einsum("...chw,cd->...dhw", xf, P.to(xf.dtype))


class ECOTracker(BaseTracker):
    """One instance tracks one target in one sequence. `net` has
    `extract_backbone(im)` returning float32 NCHW maps by layer name."""

    def __init__(self, params: ECOParams, net, device="cuda"):
        super().__init__(params, device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self._scale_factors = self._f32(list(params.scale_factors))
        self._translation_weights = [b[3] for b in params.blocks]
        self.state: Optional[ECOState] = None
        self._seed = 0
        self._generator: Optional[torch.Generator] = None

    def _f32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=self.device)

    def _keep_mask(self, shape, prob: float) -> torch.Tensor:
        """Bernoulli(1 - prob) keep mask (the dropout augmentation)."""
        return torch.rand(shape, generator=self._generator, device=self.device) < 1.0 - prob

    # ---------------------------------------------------------------- features

    def _backbone_blocks(self, im_patches) -> List[torch.Tensor]:
        """(B, 3, s, s) -> per block (B, C_b, h_b, w_b): average pooling, then
        normalisation by (sum |f|^p / n + 1e-10)^(1/p) per sample."""
        p = self.params
        feats = self.net.extract_backbone(im_patches)
        out = []
        for layer, pool in p.feature_blocks:
            f = feats[layer]
            if pool > 1:
                f = F.avg_pool2d(f, pool, pool)
            if p.normalize_power is not None:
                q = p.normalize_power
                n = f.shape[1] * f.shape[2] * f.shape[3]
                f = f / (torch.sum(torch.abs(f) ** q, dim=(1, 2, 3), keepdim=True) / n
                         + 1e-10) ** (1.0 / q)
            out.append(f)
        return out

    # ---------------------------------------------------------------- geometry

    def _compute_sizes(self, target_sz: np.ndarray):
        """Host: the sample size (≡ the deepest stride mod twice it, so the
        deepest grid is odd), the target scale, the feature and the odd
        filter grid sizes per block."""
        p = self.params
        search_area = float(np.prod(np.asarray(target_sz) * p.search_area_scale))
        target_scale = 1.0
        if search_area > p.max_image_sample_size:
            target_scale = math.sqrt(search_area / p.max_image_sample_size)
        elif search_area < p.min_image_sample_size:
            target_scale = math.sqrt(search_area / p.min_image_sample_size)
        base_target_sz = np.asarray(target_sz) / target_scale
        sz = round(math.sqrt(float(np.prod(base_target_sz * p.search_area_scale))))
        stride = max(b[0] for b in p.blocks)
        sz += int(stride - sz % (2 * stride))
        feat_szs = [sz // b[0] for b in p.blocks]
        filt_szs = [f + (f + 1) % 2 for f in feat_szs]
        return int(sz), float(target_scale), feat_szs, filt_szs

    def _fourier_sample(self, feat: torch.Tensor, b: int) -> torch.Tensor:
        """(..., C, h, w) -> its windowed centred spectrum on the filter grid
        times the bicubic interpolation kernel, (..., C, fh, fw)."""
        xf = fourier.cfft2(feat * self._windows[b])
        xf = fourier.pad_fs(xf, (self._filt_szs[b],) * 2)
        fy, fx = self._interp[b]
        return xf * fy * fx

    # ---------------------------------------------------------------- residuals

    def _make_residual(self, samples_f, sample_weights, with_proj: bool):
        """Residual over {'hf': [...]} (and 'P' with `with_proj`, `samples_f`
        then the unprojected spectra)."""
        p = self.params
        sqrt_w = torch.sqrt(sample_weights)[:, None, None]

        def residual(v):
            res = {}
            for b, filt_sz in enumerate(self._filt_szs):
                hf = v["hf"][b]
                xf = _project(samples_f[b], v["P"][b]) if with_proj else samples_f[b]
                scores_f = torch.sum(xf * hf[None], dim=1)                # (M, fh, fw)
                res[f"data{b}"] = sqrt_w * (scores_f - self._yfs[b][None])
                h_spatial = torch.fft.ifft2(torch.fft.ifftshift(hf, dim=(-2, -1)))
                res[f"reg{b}"] = math.sqrt(filt_sz ** 2) * self._reg_windows[b][None] * h_spatial
                if with_proj:
                    res[f"preg{b}"] = math.sqrt(p.projection_reg) * v["P"][b]
            return res

        return residual

    def _precond(self, sample_energy, with_proj: bool, proj_energy=None):
        p = self.params

        def M(v):
            out = {"hf": []}
            if with_proj:
                out["P"] = []
            for b in range(len(self._filt_szs)):
                se = sample_energy[b]
                diag = (1 - p.precond_reg_param) * (
                    p.precond_data_param * se +
                    (1 - p.precond_data_param) * se.mean(0, keepdim=True)) + \
                    p.precond_reg_param * self._reg_energies[b]
                out["hf"].append(v["hf"][b] / torch.clamp(diag, min=1e-10))
                if with_proj:
                    out["P"].append(v["P"][b] / (p.precond_proj_param *
                                                 (proj_energy[b] + p.projection_reg)))
            return out

        return M

    # ---------------------------------------------------------------- host API

    @torch.no_grad()
    @ieee_float32()
    def initialize(self, image, info: Dict[str, Any]) -> dict:
        """image (H, W, 3) RGB; info['init_bbox'] = [x, y, w, h]."""
        p = self.params
        im = self._image_tensor(image)
        bbox_np = np.asarray(info["init_bbox"], np.float32)
        target_sz = np.array([bbox_np[3], bbox_np[2]])
        sample_sz, target_scale, feat_szs, filt_szs = self._compute_sizes(target_sz)
        self._sample_sz, self._feat_szs, self._filt_szs = sample_sz, feat_szs, filt_szs
        self._support = self._f32([float(sample_sz)] * 2)
        self._generator = torch.Generator(device=self.device).manual_seed(self._seed)
        self._aug_rng = np.random.RandomState(self._seed)

        # per-sequence constants: windows, interpolation kernels, labels,
        # regularisation windows and their energies
        base_target_sz = target_sz / target_scale
        self._windows, self._interp, self._yfs = [], [], []
        self._reg_windows, self._reg_energies = [], []
        for b, (_, _, sigma_f, _, reg_edge) in enumerate(p.blocks):
            fsz = filt_szs[b]
            self._windows.append(dcf.hann2d((feat_szs[b],) * 2, self.device))
            self._interp.append(dcf.get_interp_fourier((fsz, fsz), "bicubic",
                                                       device=self.device))
            sigma = (fsz / float(sample_sz)) * math.sqrt(float(np.prod(base_target_sz))) * \
                sigma_f
            self._yfs.append(dcf.label_function((fsz, fsz), (sigma, sigma), self.device)
                             .to(torch.complex64))
            tgrid = self._f32(base_target_sz * fsz / float(sample_sz))
            g = torch.arange(fsz, dtype=torch.float32, device=self.device) - (fsz - 1) / 2
            win = (2.0 / tgrid[0] * torch.abs(g))[:, None] ** p.reg_window_power + \
                (2.0 / tgrid[1] * torch.abs(g))[None, :] ** p.reg_window_power
            w = (reg_edge - p.reg_window_min) * win + p.reg_window_min
            self._reg_windows.append(w)
            self._reg_energies.append(torch.sum(w * w) / fsz ** 2)

        bbox = self._f32(bbox_np)
        image_sz = self._f32([im.shape[1], im.shape[2]])
        target_scale = self._f32(target_scale)
        self.state = self._initialize_from_patch(self._init_crop(im, bbox, target_scale,
                                                                 image_sz),
                                                 bbox, target_scale, image_sz)
        return {}

    @torch.no_grad()
    @ieee_float32()
    def track(self, image, info: Optional[dict] = None) -> dict:
        im = self._image_tensor(image)
        self.state, out = self._track_from_patch(self.state, self._track_crop(self.state, im))
        host = torch.cat([out["target_bbox"], out["max_score"][None]]).cpu().numpy()  # the sync
        if self.state.frame_num % self.params.train_skipping == 1:
            self._update_filter()
        return {"target_bbox": host[:4].tolist(), "max_score": float(host[4])}

    # ---------------------------------------------------------------- initialize

    def _target_pos(self, bbox):
        return torch.stack([bbox[1] + (bbox[3] - 1) / 2, bbox[0] + (bbox[2] - 1) / 2])

    def _init_crop(self, im, bbox, target_scale, image_sz) -> torch.Tensor:
        p = self.params
        s = self._sample_sz
        exp_sz = int(round(s * p.augmentation_expansion_factor))
        exp_sz += (exp_sz - s) % 2
        base_patch, _ = sample_patch(im, torch.round(self._target_pos(bbox)),
                                     (target_scale * exp_sz).expand(2), (exp_sz, exp_sz),
                                     mode=p.border_mode, im_sz=image_sz)
        return base_patch

    def _initialize_from_patch(self, base_patch, bbox, target_scale, image_sz) -> ECOState:
        p = self.params
        s = self._sample_sz
        nb = len(p.blocks)
        pos = self._target_pos(bbox)
        target_sz = torch.stack([bbox[3], bbox[2]])
        base_target_sz = target_sz / target_scale
        init_pos = torch.round(pos)

        augs = p.aug_dict()
        transforms = aug.build_transforms({k: v for k, v in augs.items() if k != "dropout"},
                                          (s, s), 0.0, self._aug_rng)
        feats = self._backbone_blocks(aug.apply_all(base_patch, transforms, (s, s)))
        if "dropout" in augs:
            num_drop, prob = augs["dropout"]
            feats = [torch.cat([f, aug.dropout2d(f, self._keep_mask((num_drop, f.shape[1], 1, 1),
                                                                    prob), prob)])
                     for f in feats]
        T = feats[0].shape[0]

        # PCA projections: the leading right singular vectors of the
        # channel covariance over every init sample's pixels
        projs = []
        for f, (_, cdim, *_rest) in zip(feats, p.blocks):
            mat = f.permute(0, 2, 3, 1).reshape(-1, f.shape[1])
            mat = mat - mat.mean(dim=0, keepdim=True)
            _, _, vt = torch.linalg.svd(mat.T @ mat)
            projs.append(vt[:cdim].T.contiguous())                # (Cin, cdim)

        # spectra shifted so that every sample's target is centred: undo the
        # pure-shift augmentations and the target's sub-pixel offset
        shift_back = np.zeros((T, 2), np.float32)
        for i, t in enumerate(transforms):
            if t.kind == "identity":
                shift_back[i] = t.shift
        sub_pix = (pos - init_pos) / target_scale
        shift_norm = (2 * math.pi / float(s)) * (self._f32(shift_back) + sub_pix[None, :])
        raw, samples_f = [], []
        for b, f in enumerate(feats):
            xf = fourier.shift_fs(self._fourier_sample(f, b), shift_norm[:, None, :])
            raw.append(xf)
            samples_f.append(_project(xf, projs[b]))

        M = p.sample_memory_size
        mem = []
        for b in range(nb):
            buf = samples_f[b].new_zeros((M,) + samples_f[b].shape[1:])
            buf[:T] = samples_f[b]
            mem.append(buf)
        sample_weights = torch.zeros(M, device=self.device)
        sample_weights[:T] = 1.0 / T
        sample_energy = [(torch.abs(sf) ** 2).mean(dim=0) for sf in samples_f]
        proj_energy = [2 * torch.real(torch.vdot(yf.reshape(-1), yf.reshape(-1))) /
                       self._filt_szs[b] ** 2 * torch.ones_like(pr)
                       for b, (yf, pr) in enumerate(zip(self._yfs, projs))]

        # joint fit of {hf, P}
        filters0 = [torch.zeros(sf.shape[1:], dtype=torch.complex64, device=self.device)
                    for sf in samples_f]
        residual = self._make_residual(raw, torch.full((T,), 1.0 / T, device=self.device), True)
        res = solvers.gauss_newton_cg(
            residual, {"hf": filters0, "P": projs}, num_gn_iter=p.init_GN_iter,
            num_cg_iter=max(p.init_CG_iter // max(p.init_GN_iter, 1), 1),
            precond=self._precond(sample_energy, True, proj_energy))
        filters, projs = res.x["hf"], res.x["P"]
        for b in range(nb):                  # the memory re-projected
            mem[b][:T] = _project(raw[b], projs[b])

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)

        return ECOState(
            pos=pos, target_sz=target_sz, target_scale=target_scale,
            base_target_sz=base_target_sz, image_sz=image_sz,
            min_scale=torch.max(10.0 / base_target_sz),
            max_scale=torch.min(image_sz / base_target_sz), filters=list(filters),
            proj=list(projs), samples_f=mem, sample_energy=sample_energy,
            sample_weights=sample_weights, num_stored=i32(T), prev_ind=i32(-1), frame_num=1,
            scale_ind=torch.zeros((), dtype=torch.long, device=self.device),
            max_score=torch.ones((), device=self.device))

    # ---------------------------------------------------------------- track

    def _track_crop(self, state: ECOState, im) -> torch.Tensor:
        """One sample per scale factor around the rounded position,
        (S, 3, s, s)."""
        s = self._sample_sz
        S = self._scale_factors.shape[0]
        sample_sz = (self._scale_factors * state.target_scale)[:, None] * self._support
        return sample_patch(im, torch.round(state.pos).expand(S, 2), sample_sz, (s, s),
                            mode=self.params.border_mode, im_sz=state.image_sz)[0]

    def _score_maps(self, state: ECOState, feats):
        """Per scale the score map on the sample's pixel grid (S, o, o) and
        the projected spectra per block (S, c, fh, fw): each block's
        spectrum summed over channels, weighted, summed on a common grid."""
        out_sz = self.params.score_upsample_factor * self._sample_sz
        spectra, test_xf = [], []
        for b, f in enumerate(feats):
            xfp = _project(self._fourier_sample(f, b), state.proj[b])
            test_xf.append(xfp)
            spectra.append(self._translation_weights[b] *
                           torch.sum(xfp * state.filters[b][None], dim=1))
        return fourier.sample_fs(fourier.sum_fs(spectra), (out_sz, out_sz)), test_xf

    def _track_from_patch(self, state: ECOState, patches):
        p = self.params
        s = self._sample_sz
        out_sz = p.score_upsample_factor * s
        state = dataclasses.replace(state, frame_num=state.frame_num + 1)
        sample_pos = torch.round(state.pos)
        scores, test_xf = self._score_maps(state, self._backbone_blocks(patches))

        max_sc, max_disp = dcf.max2d(scores)
        scale_ind = torch.argmax(max_sc)
        disp = take(max_disp, scale_ind).float()
        disp_mod = torch.remainder(disp + out_sz / 2, out_sz) - out_sz / 2
        factor = take(self._scale_factors, scale_ind)
        sample_scale = state.target_scale * factor
        translation = disp_mod * (float(s) / out_sz) * state.target_scale * factor
        new_scale = torch.minimum(torch.maximum(sample_scale, state.min_scale), state.max_scale)
        inside_offset = (p.target_inside_ratio - 0.5) * state.base_target_sz * new_scale
        pos = torch.maximum(torch.minimum(sample_pos + translation,
                                          state.image_sz - inside_offset), inside_offset)
        state = dataclasses.replace(state, pos=pos, target_scale=new_scale,
                                    target_sz=state.base_target_sz * new_scale)
        # the sample shifted so that the target sits at the patch centre
        shift = (2 * math.pi) * (state.pos - sample_pos) / (sample_scale * float(s))
        state = self._update_memory(state, [fourier.shift_fs(
            x.index_select(0, scale_ind.reshape(1))[0], shift) for x in test_xf])

        max_score = take(max_sc, scale_ind)
        state = dataclasses.replace(state, scale_ind=scale_ind, max_score=max_score)
        bbox = torch.cat([state.pos.flip(-1) - (state.target_sz.flip(-1) - 1) / 2,
                          state.target_sz.flip(-1)])
        return state, {"target_bbox": bbox, "max_score": max_score}

    def _update_memory(self, state: ECOState, samples) -> ECOState:
        """The frame's spectra per block (c, fh, fw) into the next free slot,
        else the lightest one; the sample energies' running mean."""
        M = self.params.sample_memory_size
        lr = self.params.learning_rate
        sw = state.sample_weights
        r_ind = torch.where(state.num_stored < M, state.num_stored.long(), torch.argmin(sw))
        prev = state.prev_ind
        sw_new = torch.where(prev < 0, sw / (1 - lr), sw)
        new_w = torch.where(prev < 0, lr, take(sw, torch.clamp(prev, min=0)) / (1 - lr))
        sw_new = torch.where(torch.arange(M, device=self.device) == r_ind, new_w, sw_new)
        sw_new = sw_new / sw_new.sum()
        for mem, x in zip(state.samples_f, samples):
            mem.index_copy_(0, r_ind.reshape(1), x[None])
        return dataclasses.replace(
            state, sample_weights=sw_new,
            sample_energy=[(1 - lr) * e + lr * torch.abs(x) ** 2
                           for e, x in zip(state.sample_energy, samples)],
            num_stored=torch.clamp(state.num_stored + 1, max=M), prev_ind=r_ind.to(torch.int32))

    def _update_filter(self) -> None:
        """The filter-only refit over the memory: one Gauss-Newton step of
        `CG_iter` CG iterations."""
        state = self.state
        residual = self._make_residual(state.samples_f, state.sample_weights, False)
        res = solvers.gauss_newton_cg(residual, {"hf": list(state.filters)}, num_gn_iter=1,
                                      num_cg_iter=self.params.CG_iter,
                                      precond=self._precond(state.sample_energy, False))
        self.state = dataclasses.replace(state, filters=list(res.x["hf"]))


def get_tracker_class():
    return ECOTracker
