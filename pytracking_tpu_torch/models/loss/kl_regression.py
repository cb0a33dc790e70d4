"""Probabilistic regression losses of PrDiMP and ATOM's prob-ML recipe
(counterpart of pytracking_tpu/models/loss/kl_regression.py:
`kl_regression`, `ml_regression`, `kl_regression_grid`)."""

from __future__ import annotations

import math

import torch


def kl_regression(scores: torch.Tensor, sample_density: torch.Tensor,
                  gt_density: torch.Tensor, mc_dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """KL divergence between the Gibbs density exp(scores) / Z and the
    ground-truth density, Monte-Carlo estimated over the samples along
    `mc_dim`, drawn from `sample_density`; the mean over the rest."""
    exp_val = scores - torch.log(sample_density + eps)
    n = scores.shape[mc_dim]
    L = torch.logsumexp(exp_val, dim=mc_dim) - math.log(n) \
        - torch.mean(scores * (gt_density / (sample_density + eps)), dim=mc_dim)
    return L.mean()


def ml_regression(scores: torch.Tensor, sample_density: torch.Tensor, gt_density=None,
                  mc_dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """Negative log-likelihood of sample 0 along `mc_dim` (the ground
    truth), its normaliser importance-sampled from the other samples."""
    assert mc_dim in (1, -1)
    mc_dim = mc_dim % scores.dim()
    n = scores.shape[mc_dim] - 1
    exp_val = scores - torch.log(sample_density + eps)
    norm = torch.logsumexp(exp_val.narrow(mc_dim, 1, n), dim=mc_dim) - math.log(n)
    return (norm - scores.select(mc_dim, 0)).mean()


def kl_regression_grid(scores: torch.Tensor, gt_density: torch.Tensor, grid_dim=(-2, -1),
                       grid_scale: float = 1.0) -> torch.Tensor:
    """KL divergence of the softmax of scores over the last two dims (a
    uniform grid of cell `grid_scale`) from `gt_density`; the mean over the
    rest."""
    score_corr = grid_scale * torch.sum(scores * gt_density, dim=grid_dim)
    L = torch.logsumexp(scores.flatten(-2), dim=-1) + math.log(grid_scale) - score_corr
    return L.mean()
