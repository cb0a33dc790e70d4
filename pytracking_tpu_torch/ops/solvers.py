"""Least-squares and minimisation solvers over trees of tensors (counterpart
of pytracking_tpu/ops/solvers.py: `cg_solve`, `gauss_newton_cg`,
`gradient_descent_l2`, `newton_cg`, `gradient_descent`).

Variables are nested dicts, lists and tuples of tensors; dict leaves are
taken in sorted key order, as JAX orders a pytree's. Iteration counts are
host integers and each solve is a Python loop of fixed-shape tensor ops: no
value is read back to the host inside a solve, and CG's guard against a
vanishing curvature or residual is a tensor flag that freezes the iterate.
Jacobian products come from `torch.func.jvp` / `torch.func.vjp` (gradients
from `torch.func.grad_and_value`), which ignore an enclosing
`torch.no_grad()`.

Complex variables (ECO's Fourier filters) are solved in the real view: every
complex leaf of the variables and of the residual is split into a trailing
[real, imag] pair, the solver runs on the purely real problem (whose normal
equations are the complex JᴴJ) and the result is mapped back. This fixes the
operator independently of the autodiff library's complex cotangent
convention, under which vjp(jvp(v)) of a complex residual is not JᴴJ.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

Tree = Any


# ---------------------------------------------------------------- tree math

def tree_leaves(tree: Tree) -> list:
    """The tensors of `tree`, dict entries in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_vdot(a: Tree, b: Tree) -> torch.Tensor:
    """Sum over the leaves of the real part of <a, b> (a conjugated)."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = torch.real(torch.vdot(x.reshape(-1), y.reshape(-1)))
        total = d if total is None else total + d
    return total


def tree_add(a: Tree, b: Tree, alpha=1.0) -> Tree:
    return tree_map(lambda x, y: x + alpha * y, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: s * x, a)


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


# ---------------------------------------------------------------- real view

def _any_complex(tree: Tree) -> bool:
    return any(x.is_complex() for x in tree_leaves(tree))


def _c2r(tree: Tree) -> Tree:
    return tree_map(lambda x: torch.stack([x.real, x.imag], dim=-1) if x.is_complex() else x,
                    tree)


def _r2c(tree: Tree, like: Tree) -> Tree:
    """The complex leaves of `like` rebuilt from their real views in `tree`."""
    return tree_map(lambda x, c: torch.complex(x[..., 0], x[..., 1]) if c.is_complex() else x,
                    tree, like)


def _realview_residual(residual_fn: Callable, like: Tree) -> Callable:
    """A residual on trees shaped like `like` (possibly complex) as a
    function from the real view to the real view."""
    return lambda xr: _c2r(residual_fn(_r2c(xr, like)))


# ---------------------------------------------------------------- conjugate gradient

class CGResult(NamedTuple):
    x: Tree
    residual_norms: torch.Tensor   # (max_iter + 1,) ||r||² before and after each iteration


def cg_solve(A: Callable[[Tree], Tree], b: Tree, x0: Optional[Tree] = None,
             max_iter: int = 10, precond: Optional[Callable[[Tree], Tree]] = None,
             fletcher_reeves: bool = True, eps: float = 0.0) -> CGResult:
    """Preconditioned conjugate gradient for A x = b, A symmetric positive
    definite: alpha = rho / <p, Ap>, beta by Fletcher-Reeves (rho / rho_prev)
    or Polak-Ribière (clamped at 0). `max_iter` iterations; once <p, Ap> or
    rho is at most `eps` the iterate stays where it is."""
    if x0 is None:
        x, r = tree_zeros_like(b), b
    else:
        x, r = x0, tree_sub(b, A(x0))
    M = precond if precond is not None else (lambda v: v)
    z = M(r)
    rho = tree_vdot(r, z)
    p = z
    ok = torch.ones((), dtype=torch.bool, device=rho.device)
    norms = [tree_vdot(b, b) if x0 is None else tree_vdot(r, r)]
    for _ in range(max_iter):
        q = A(p)
        pq = tree_vdot(p, q)
        ok = ok & (pq > eps) & (rho > eps)
        alpha = torch.where(ok, rho / torch.where(pq == 0, 1.0, pq), 0.0)
        x = tree_add(x, p, alpha)
        r_prev = r
        r = tree_add(r, q, -alpha)
        z = M(r)
        rho_new = tree_vdot(r, z)
        rho_safe = torch.where(rho == 0, 1.0, rho)
        if fletcher_reeves:
            beta = rho_new / rho_safe
        else:
            beta = torch.clamp((rho_new - tree_vdot(r_prev, z)) / rho_safe, min=0.0)
        beta = torch.where(ok, beta, 0.0)
        p = tree_add(z, p, beta)
        rho = rho_new
        norms.append(tree_vdot(r, r))
    return CGResult(x, torch.stack(norms))


# ---------------------------------------------------------------- Gauss-Newton

class SolveResult(NamedTuple):
    x: Tree
    losses: torch.Tensor   # the loss at each outer iteration's start


def gauss_newton_cg(residual_fn: Callable[[Tree], Tree], x0: Tree, num_gn_iter: int = 5,
                    num_cg_iter: int = 10,
                    precond: Optional[Callable[[Tree], Tree]] = None) -> SolveResult:
    """Gauss-Newton with inner CG: each outer iteration CG-solves
    (JᵀJ) dx = Jᵀ r at the current x, then x <- x - dx. Complex variables
    are solved in the real view."""
    if _any_complex(x0):
        like = x0
        pre = None if precond is None else (lambda vr: _c2r(precond(_r2c(vr, like))))
        res = gauss_newton_cg(_realview_residual(residual_fn, like), _c2r(x0),
                              num_gn_iter=num_gn_iter, num_cg_iter=num_cg_iter, precond=pre)
        return SolveResult(_r2c(res.x, like), res.losses)
    x = x0
    losses = []
    for _ in range(num_gn_iter):
        r, vjp_fn = torch.func.vjp(residual_fn, x)
        losses.append(tree_vdot(r, r))

        def JtJ(v, x=x, vjp_fn=vjp_fn):
            _, Jv = torch.func.jvp(residual_fn, (x,), (v,))
            return vjp_fn(Jv)[0]

        dx = cg_solve(JtJ, vjp_fn(r)[0], max_iter=num_cg_iter, precond=precond).x
        x = tree_sub(x, dx)
    return SolveResult(x, torch.stack(losses))


def _momentum_descent(loss_fn: Callable[[Tree], torch.Tensor], x0: Tree, num_iter: int,
                      step_length: float, momentum: float) -> SolveResult:
    x, vel = x0, tree_zeros_like(x0)
    losses = []
    for _ in range(num_iter):
        g, loss = torch.func.grad_and_value(loss_fn)(x)
        losses.append(loss)
        vel = tree_add(tree_scale(vel, momentum), g)
        x = tree_add(x, vel, -step_length)
    return SolveResult(x, torch.stack(losses))


def gradient_descent_l2(residual_fn: Callable[[Tree], Tree], x0: Tree, num_iter: int = 10,
                        step_length: float = 1.0, momentum: float = 0.0) -> SolveResult:
    """Momentum gradient descent on L(x) = ||r(x)||²."""
    if _any_complex(x0):
        res = gradient_descent_l2(_realview_residual(residual_fn, x0), _c2r(x0),
                                  num_iter=num_iter, step_length=step_length,
                                  momentum=momentum)
        return SolveResult(_r2c(res.x, x0), res.losses)

    def loss_fn(x):
        r = residual_fn(x)
        return tree_vdot(r, r)

    return _momentum_descent(loss_fn, x0, num_iter, step_length, momentum)


def newton_cg(loss_fn: Callable[[Tree], torch.Tensor], x0: Tree, num_newton_iter: int = 5,
              num_cg_iter: int = 10, hessian_reg: float = 0.0) -> SolveResult:
    """Newton's method on a scalar loss, each step CG-solved with
    Hessian-vector products (jvp of the gradient)."""
    if _any_complex(x0):
        res = newton_cg(lambda xr: loss_fn(_r2c(xr, x0)), _c2r(x0),
                        num_newton_iter=num_newton_iter, num_cg_iter=num_cg_iter,
                        hessian_reg=hessian_reg)
        return SolveResult(_r2c(res.x, x0), res.losses)
    grad_fn = torch.func.grad(loss_fn)
    x = x0
    losses = []
    for _ in range(num_newton_iter):
        g = grad_fn(x)

        def Hv(v, x=x):
            hv = torch.func.jvp(grad_fn, (x,), (v,))[1]
            return tree_add(hv, v, hessian_reg) if hessian_reg > 0 else hv

        dx = cg_solve(Hv, g, max_iter=num_cg_iter).x
        losses.append(loss_fn(x))
        x = tree_sub(x, dx)
    return SolveResult(x, torch.stack(losses))


def gradient_descent(loss_fn: Callable[[Tree], torch.Tensor], x0: Tree, num_iter: int = 10,
                     step_length: float = 1.0, momentum: float = 0.0) -> SolveResult:
    """Momentum gradient descent on a scalar loss."""
    if _any_complex(x0):
        res = gradient_descent(lambda xr: loss_fn(_r2c(xr, x0)), _c2r(x0), num_iter=num_iter,
                               step_length=step_length, momentum=momentum)
        return SolveResult(_r2c(res.x, x0), res.losses)
    return _momentum_descent(loss_fn, x0, num_iter, step_length, momentum)
