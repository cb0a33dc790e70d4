"""Activations with analytic derivatives for the unrolled filter optimizers
(counterpart of pytracking_tpu/ops/activation.py)."""

from __future__ import annotations

import torch


def softmax_reg(x: torch.Tensor, dim: int, reg=None) -> torch.Tensor:
    """Softmax with an optional constant logit `reg` appended to the
    denominator along `dim`."""
    if reg is None:
        return torch.softmax(x, dim=dim)
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] = 1
    xs = torch.cat([x, torch.full(shape, float(reg), dtype=x.dtype, device=x.device)], dim=dim)
    return torch.softmax(xs, dim=dim).narrow(dim, 0, x.shape[dim])


def mlu(x: torch.Tensor, min_val: float) -> torch.Tensor:
    """elu(leaky_relu(x, 1/min_val), min_val)."""
    y = torch.where(x >= 0, x, x / min_val)
    return torch.where(y >= 0, y, min_val * (torch.exp(y) - 1.0))


def leaky_relu_par(x: torch.Tensor, a) -> torch.Tensor:
    """Parametric leaky ReLU (1-a)/2 |x| + (1+a)/2 x; DiMP's target mask is
    the slope a. |x| is written so that its derivative at 0 is +1, JAX's
    convention for `abs` (torch's is 0): the Jacobian products of RTS's
    hinge descent meet exact zeros where the filter's taps are zero."""
    return (1.0 - a) / 2.0 * torch.where(x >= 0, x, -x) + (1.0 + a) / 2.0 * x


def leaky_relu_par_deriv(x: torch.Tensor, a) -> torch.Tensor:
    """d/dx of leaky_relu_par, with sign(x) taken on a detached x."""
    return (1.0 - a) / 2.0 * torch.sign(x.detach()) + (1.0 + a) / 2.0


def bent_ident_par(x: torch.Tensor, a, b: float = 1.0) -> torch.Tensor:
    """Bent-identity parametric activation."""
    return (1.0 - a) / 2.0 * (torch.sqrt(x * x + 4.0 * b * b) - 2.0 * b) + (1.0 + a) / 2.0 * x


def bent_ident_par_deriv(x: torch.Tensor, a, b: float = 1.0) -> torch.Tensor:
    """d/dx of bent_ident_par."""
    return (1.0 - a) / 2.0 * (x / torch.sqrt(x * x + 4.0 * b * b)) + (1.0 + a) / 2.0
