"""Generic unrolled Gauss-Newton steepest descent (counterpart of
pytracking_tpu/models/meta/steepestdescent.py `gn_steepest_descent`).

Given a residual function r(x), each iteration computes g = Jᵀr by
`torch.func.vjp`, h = Jg by `torch.func.jvp`, the per-sequence step
α = ‖g‖² / (‖h‖² + reg·‖g‖²) (the denominator clamped at 1e-8), and
x ← x − α·g. The iteration count is a host integer: a Python loop of
fixed-shape ops with no readback.

`torch.func` transforms ignore an enclosing `torch.no_grad()`, so the
tracker calls this inside its `no_grad` step; tensors made under
`torch.inference_mode()` cannot enter them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._pytree import tree_leaves


def _batch_sqr_norm(tree: Any, batch_dim: int, num_batch: int) -> torch.Tensor:
    """Sum of squares per batch element: each leaf is reduced over every dim
    but `batch_dim`."""
    total = None
    for leaf in tree_leaves(tree):
        dims = tuple(d for d in range(leaf.dim()) if d != batch_dim)
        s = torch.sum(leaf * leaf, dim=dims).reshape(num_batch)
        total = s if total is None else total + s
    return total


def gn_steepest_descent(residual_fn: Callable[[torch.Tensor], Any], x0: torch.Tensor,
                        num_iter: int, residual_batch_dim: int = 1,
                        steplength_reg: float = 0.0, return_iterates: bool = False,
                        compute_losses: bool = False):
    """Run `num_iter` steps on x (dim 0 = the sequences). `residual_fn`
    returns a pytree of tensors whose `residual_batch_dim` is the sequence
    axis. Returns the final x; with `return_iterates` the triple (x,
    iterates (num_iter, *x.shape), losses): the losses, with
    `compute_losses`, are the mean squared residual before each step and
    after the last (num_iter + 1 entries; empty without).

    Nothing is detached: under autograd the result is differentiable in x0
    and in every tensor `residual_fn` closes over, through the unrolled
    steps, as the training forward needs."""
    S = x0.shape[0]
    x = x0
    shape = (-1,) + (1,) * (x0.dim() - 1)

    def loss_of(r):
        leaves = tree_leaves(r)
        total = sum(torch.sum(leaf * leaf) for leaf in leaves)
        return total / sum(leaf.numel() for leaf in leaves)

    iterates, losses = [], []
    for _ in range(num_iter):
        r, vjp_fn = torch.func.vjp(residual_fn, x)
        if compute_losses:
            losses.append(loss_of(r))
        g, = vjp_fn(r)
        _, h = torch.func.jvp(residual_fn, (x,), (g,))
        ip_gg = _batch_sqr_norm(g, 0, S)
        ip_hh = _batch_sqr_norm(h, residual_batch_dim, S)
        alpha = ip_gg / torch.clamp(ip_hh + steplength_reg * ip_gg, min=1e-8)
        x = x - alpha.reshape(shape) * g
        if return_iterates:
            iterates.append(x)
    if not return_iterates:
        return x
    if compute_losses:
        losses.append(loss_of(residual_fn(x)))
    return x, torch.stack(iterates), torch.stack(losses) if compute_losses else x.new_zeros(0)
