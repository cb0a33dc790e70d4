"""DiMP's and PrDiMP's unrolled filter optimisers (counterpart of
pytracking_tpu/models/classifier/optimizer.py `DiMPSteepestDescentGN`,
`PrDiMPSteepestDescentNewton`).

Shapes: weights (S, 1, C, fh, fw); feat (N, S, C, H, W); bb (N, S, 4) as
(x, y, w, h) in image-patch coordinates; sample_weight (N, S) or None. The
iteration count is a host integer, so the loop is a plain Python loop of
fixed-shape tensor ops with no readback. The filter correlations run one
convolution per sequence (`ops.filter.*_per_sequence`): with S > 1 (the
streams of the batched server) cuDNN's grouped ones are several times
slower.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pytracking_tpu_torch.ops import activation as act
from pytracking_tpu_torch.ops.distance import distance_map
from pytracking_tpu_torch.ops.filter import (apply_feat_transpose_per_sequence,
                                             apply_filter_per_sequence)


def initial_label_map_w(d: torch.Tensor, sigma: float) -> torch.Tensor:
    """The label map's initial per-bin weights over bin distances `d`: a
    Gaussian of `sigma` less its least value, or one-hot on bin 0 when
    sigma is 0."""
    if sigma == 0:
        init_gauss = torch.zeros_like(d)
        init_gauss[0] = 1.0
    else:
        init_gauss = torch.exp(-0.5 * (d / sigma) ** 2)
    return init_gauss - init_gauss.min()


def _step_length_and_reg(opt):
    """exp(log_step_length) and filter_reg² (clamped at min_filter_reg²),
    computed in `opt.param_dtype`: bf16 where the weights are stored as
    bf16 (`utils/loading.round_to_bf16_`), as flax computes them from bf16
    parameters; the result then promotes to the float32 tensors it meets."""
    log_step, filter_reg = (x.to(opt.param_dtype) for x in (opt.log_step_length, opt.filter_reg))
    return (torch.exp(log_step)[0],
            torch.clamp(filter_reg * filter_reg, min=opt.min_filter_reg ** 2)[0])


class DiMPSteepestDescentGN(nn.Module):
    """Steepest descent with a Gauss-Newton step length on the learned
    residual: label map y, target mask m (through a sigmoid) and spatial
    weight v are linear in a binned distance map of the target centre,
    their per-bin weights are parameters; the scores go through the
    parametric leaky ReLU with slope m. The five parameters start at the
    JAX package's structured values (a seeded net learns a usable filter
    from them)."""

    min_filter_reg = 1e-3
    param_dtype = torch.float32

    def __init__(self, num_iter: int = 1, feat_stride: int = 16,
                 init_step_length: float = 1.0, init_filter_reg: float = 1e-2,
                 init_gauss_sigma: float = 1.0, num_dist_bins: int = 5,
                 bin_displacement: float = 1.0, mask_init_factor: float = 4.0):
        super().__init__()
        self.num_iter = num_iter
        self.feat_stride = feat_stride
        self.num_dist_bins = num_dist_bins
        self.bin_displacement = bin_displacement

        self.log_step_length = nn.Parameter(torch.full((1,), math.log(init_step_length)))
        self.filter_reg = nn.Parameter(torch.full((1,), float(init_filter_reg)))
        d = torch.arange(num_dist_bins, dtype=torch.float32) * bin_displacement
        self.label_map_w = nn.Parameter(initial_label_map_w(d, init_gauss_sigma))
        self.target_mask_w = nn.Parameter(mask_init_factor * torch.tanh(2.0 - d))
        self.spatial_weight_w = nn.Parameter(torch.ones(num_dist_bins))

    def _predictors(self, bb: torch.Tensor, filter_sz, output_sz):
        """Label map, target mask and spatial weight, each (N*S, H, W), from
        the distance map of the target centres."""
        center = ((bb[..., :2] + bb[..., 2:] / 2) / self.feat_stride).reshape(-1, 2).flip(-1)
        # (x, y) -> (y, x), less half a cell per odd filter dimension
        center = torch.stack([center[:, 0] - (filter_sz[0] % 2) / 2.0,
                              center[:, 1] - (filter_sz[1] % 2) / 2.0], dim=-1)
        dmap = distance_map(center, output_sz, self.num_dist_bins, self.bin_displacement)
        return (dmap @ self.label_map_w, torch.sigmoid(dmap @ self.target_mask_w),
                dmap @ self.spatial_weight_w)

    def forward(self, weights: torch.Tensor, feat: torch.Tensor, bb: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None,
                num_iter: Optional[int] = None, return_iterates: bool = False,
                compute_losses: bool = False):
        """The filter after `num_iter` steps. With `return_iterates`, the
        triple (weights, w_iters, losses) of the training forward: w_iters
        (num_iter, S, 1, C, fh, fw) holds the filter after each step (the
        initial one is not among them), and losses, with `compute_losses`,
        each step's loss before its update and the final filter's
        (num_iter + 1 entries; empty without). Nothing in the step is
        detached but sign(scores) in the activation's derivative."""
        num_iter = self.num_iter if num_iter is None else num_iter
        N, S = feat.shape[:2]
        fsz = (weights.shape[-2], weights.shape[-1])
        out_sz = (feat.shape[-2] + (fsz[0] + 1) % 2, feat.shape[-1] + (fsz[1] + 1) % 2)

        step_length, reg = _step_length_and_reg(self)

        label, mask, sw = (x.reshape((N, S, 1) + out_sz)
                           for x in self._predictors(bb, fsz, out_sz))
        if sample_weight is None:
            sample_weight = math.sqrt(1.0 / N) * sw
        else:
            sample_weight = torch.sqrt(sample_weight).reshape(N, S, 1, 1, 1) * sw

        def loss_of(residuals, w):
            return (torch.sum(residuals * residuals) + reg * torch.sum(w * w)) / S

        w_iters, losses = [], []
        for _ in range(num_iter):
            scores = apply_filter_per_sequence(feat, weights)             # (N, S, 1, H, W)
            score_mask = act.leaky_relu_par_deriv(scores, mask)
            residuals = sample_weight * (act.leaky_relu_par(scores, mask) - label)
            if compute_losses:
                losses.append(loss_of(residuals, weights))
            residuals_mapped = score_mask * (sample_weight * residuals)
            w_grad = apply_feat_transpose_per_sequence(feat, residuals_mapped, fsz) + reg * weights

            scores_grad = sample_weight * (score_mask * apply_filter_per_sequence(feat, w_grad))
            alpha_num = torch.sum(w_grad * w_grad, dim=(1, 2, 3, 4))               # (S,)
            alpha_den = torch.clamp(torch.sum(scores_grad ** 2, dim=(0, 2, 3, 4))
                                    + reg * alpha_num, min=1e-8)
            alpha = alpha_num / alpha_den
            weights = weights - (step_length * alpha)[:, None, None, None, None] * w_grad
            if return_iterates:
                w_iters.append(weights)
        if not return_iterates:
            return weights
        if compute_losses:
            scores = apply_filter_per_sequence(feat, weights)
            losses.append(loss_of(sample_weight * (act.leaky_relu_par(scores, mask) - label),
                                  weights))
        return weights, torch.stack(w_iters), \
            torch.stack(losses) if compute_losses else weights.new_zeros(0)


class PrDiMPSteepestDescentNewton(nn.Module):
    """Steepest descent with a Newton step length on the KL divergence
    between the softmax of the scores (with an optional constant logit
    `softmax_reg`) and a Gaussian label density at the target centre. The
    step length comes from the softmax Hessian-vector product gᵀHg; the
    regulariser is filter_reg² clamped at min_filter_reg²."""

    param_dtype = torch.float32

    def __init__(self, num_iter: int = 1, feat_stride: int = 16,
                 init_step_length: float = 1.0, init_filter_reg: float = 1e-2,
                 gauss_sigma: float = 1.0, min_filter_reg: float = 1e-3,
                 alpha_eps: float = 0.0, init_uni_weight: Optional[float] = None,
                 normalize_label: bool = False, label_shrink: float = 0.0,
                 softmax_reg: Optional[float] = None, label_threshold: float = 0.0):
        super().__init__()
        self.num_iter = num_iter
        self.feat_stride = feat_stride
        self.gauss_sigma = gauss_sigma
        self.min_filter_reg = min_filter_reg
        self.alpha_eps = alpha_eps
        self.init_uni_weight = init_uni_weight
        self.normalize_label = normalize_label
        self.label_shrink = label_shrink
        self.softmax_reg = softmax_reg
        self.label_threshold = label_threshold
        self.log_step_length = nn.Parameter(torch.full((1,), math.log(init_step_length)))
        self.filter_reg = nn.Parameter(torch.full((1,), float(init_filter_reg)))

    def get_label_density(self, center: torch.Tensor, output_sz) -> torch.Tensor:
        """(B, 2) centres (y, x) in score cells -> (B, H, W) label densities."""
        H, W = output_sz
        dev = center.device
        d0 = (torch.arange(H, dtype=torch.float32, device=dev)[None, :] - center[:, 0:1]) ** 2
        d1 = (torch.arange(W, dtype=torch.float32, device=dev)[None, :] - center[:, 1:2]) ** 2
        s2 = self.gauss_sigma ** 2
        if s2 == 0:
            # one-hot at the nearest cell on each axis
            g0 = (d0 == d0.min(dim=1, keepdim=True).values).float()
            g1 = (d1 == d1.min(dim=1, keepdim=True).values).float()
        else:
            g0 = torch.exp(-d0 / (2 * s2)) / (2 * math.pi * s2)
            g1 = torch.exp(-d1 / (2 * s2))
        gauss = g0[:, :, None] * g1[:, None, :]
        gauss = gauss * (gauss > self.label_threshold)
        if self.normalize_label:
            gauss = gauss / (gauss.sum(dim=(-2, -1), keepdim=True) + 1e-8)
        uni = 0.0 if self.init_uni_weight is None else self.init_uni_weight
        return (1.0 - self.label_shrink) * ((1.0 - uni) * gauss + uni / (H * W))

    def forward(self, weights: torch.Tensor, feat: torch.Tensor, bb: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None,
                num_iter: Optional[int] = None) -> torch.Tensor:
        num_iter = self.num_iter if num_iter is None else num_iter
        N, S = feat.shape[:2]
        fsz = (weights.shape[-2], weights.shape[-1])
        out_sz = (feat.shape[-2] + (fsz[0] + 1) % 2, feat.shape[-1] + (fsz[1] + 1) % 2)

        step_length, reg = _step_length_and_reg(self)

        center = ((bb[..., :2] + bb[..., 2:] / 2) / self.feat_stride).reshape(-1, 2).flip(-1)
        center = torch.stack([center[:, 0] - (fsz[0] % 2) / 2.0,
                              center[:, 1] - (fsz[1] % 2) / 2.0], dim=-1)
        label = self.get_label_density(center, out_sz).reshape((N, S, 1) + out_sz)
        if sample_weight is None:
            sample_weight = torch.full((N, S, 1, 1, 1), 1.0 / N, device=feat.device)
        else:
            sample_weight = sample_weight.reshape(N, S, 1, 1, 1)
        sw_ns = sample_weight.reshape(N, S)

        for _ in range(num_iter):
            scores = apply_filter_per_sequence(feat, weights)             # (N, S, 1, H, W)
            sm = act.softmax_reg(scores.reshape(N, S, -1), dim=2,
                                 reg=self.softmax_reg).reshape(scores.shape)
            res = sample_weight * (sm - label)
            w_grad = apply_feat_transpose_per_sequence(feat, res, fsz) + reg * weights

            scores_grad = apply_filter_per_sequence(feat, w_grad)
            sm_scores_grad = sm * scores_grad
            hes_scores_grad = sm_scores_grad - sm * sm_scores_grad.sum(dim=(-2, -1), keepdim=True)
            ghg = torch.clamp((scores_grad * hes_scores_grad).reshape(N, S, -1).sum(-1), min=0.0)
            ghg = (sw_ns * ghg).sum(dim=0)                                # (S,)

            alpha_num = torch.sum(w_grad * w_grad, dim=(1, 2, 3, 4))
            alpha_den = torch.clamp(ghg + (reg + self.alpha_eps) * alpha_num, min=1e-8)
            alpha = alpha_num / alpha_den
            weights = weights - (step_length * alpha)[:, None, None, None, None] * w_grad
        return weights
