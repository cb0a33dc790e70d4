"""Parity of the port's solvers, Fourier series and DCF helpers
(pytracking_tpu_torch/ops/{solvers,fourier,dcf}.py) with the JAX package's,
on the CPU, float32 / complex64.

Each case feeds the same seeded numpy inputs to both; outputs agree within
1e-5 of the larger of 1 and the reference's largest magnitude. The solver
cases are the JAX package's own (tests/test_solvers.py) plus a complex
problem with a preconditioner, Polak-Ribière, a frozen CG, and Newton /
gradient descent on complex variables.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu.ops import dcf as j_dcf
from pytracking_tpu.ops import fourier as j_fourier
from pytracking_tpu.ops import solvers as j_solvers
from pytracking_tpu_torch.ops import dcf as t_dcf
from pytracking_tpu_torch.ops import fourier as t_fourier
from pytracking_tpu_torch.ops import solvers as t_solvers
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)

TOL = 1e-5


def _close(a, b, tol=TOL):
    """|a - b| <= tol * max(1, max |b|), complex values compared as such."""
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()) if b.size else 1.0)
    np.testing.assert_allclose(a.astype(np.complex128), b.astype(np.complex128),
                               atol=tol * scale, rtol=0.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree_close(t_tree, j_tree, tol=TOL):
    tl, jl = t_solvers.tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        _close(a, b, tol)


# ---------------------------------------------------------------- problems

def _spd(n, seed):
    rng = np.random.RandomState(seed)
    m = rng.randn(n, n)
    return (m @ m.T + n * np.eye(n)).astype(np.float32), rng.randn(n).astype(np.float32)


def _complex_system(seed, m=8, n=4):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))).astype(np.complex64)
    b = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
    return A, b


def _gn_problems():
    """name -> (residual(xp, x) over a tree, x0 as numpy tree, kwargs, precond(xp, v))."""
    rng = np.random.RandomState(3)
    J = rng.randn(12, 5).astype(np.float32)
    y = rng.randn(12).astype(np.float32)
    A, b = _complex_system(0)
    A2, b2 = _complex_system(1, 6, 3)
    t = np.random.default_rng(1).standard_normal(3).astype(np.float32)
    d = np.linspace(0.5, 2.0, 4).astype(np.float32)

    def mm(xp, M, v):
        """M @ v; a complex product from real products, so that both
        libraries round it alike (XLA's complex64 dot on the CPU rounds
        differently from a real one, ~1e-5 per product, which CG amplifies)."""
        if not np.iscomplexobj(M):
            return (M @ v) if xp is jnp else torch.matmul(_t(M), v)
        Mr, Mi = (M.real.copy(), M.imag.copy()) if xp is jnp else (_t(M.real), _t(M.imag))
        vr, vi = xp.real(v), xp.imag(v)
        re, im = Mr @ vr - Mi @ vi, Mr @ vi + Mi @ vr
        return jax.lax.complex(re, im) if xp is jnp else torch.complex(re, im)

    return {
        "linear": (lambda xp, x: mm(xp, J, x) - (y if xp is jnp else _t(y)),
                   np.zeros(5, np.float32), dict(num_gn_iter=2, num_cg_iter=10), None),
        "nonlinear": (lambda xp, x: xp.stack([x[0] ** 2 - 2.0, x[1] - x[0]]),
                      np.array([1.0, 0.0], np.float32), dict(num_gn_iter=10, num_cg_iter=5),
                      None),
        "complex": (lambda xp, v: {"r": mm(xp, A, v["x"]) - (b if xp is jnp else _t(b))},
                    {"x": np.zeros(4, np.complex64)}, dict(num_gn_iter=3, num_cg_iter=20), None),
        "mixed": (lambda xp, v: {"r": mm(xp, A2, v["x"]) - (b2 if xp is jnp else _t(b2)),
                                 "s": v["w"] - (t if xp is jnp else _t(t))},
                  {"x": np.zeros(3, np.complex64), "w": np.zeros(3, np.float32)},
                  dict(num_gn_iter=3, num_cg_iter=20), None),
        # a diagonal preconditioner on the complex leaf, ECO's pattern. (At
        # 3 CG iterations per step the second step's CG is ill-conditioned
        # enough that the two float32 runs part by 2e-4, the port's run
        # being the one that agrees with float64 to 5e-6.)
        "complex_precond": (lambda xp, v: {"r": mm(xp, A, v["x"]) - (b if xp is jnp else _t(b)),
                                           "reg": 0.3 * v["x"]},
                            {"x": (0.1 + 0.2j) * np.ones(4, np.complex64)},
                            dict(num_gn_iter=2, num_cg_iter=4),
                            lambda xp, v: {"x": v["x"] / (d if xp is jnp else _t(d))}),
    }


@pytest.mark.parametrize("name", list(_gn_problems()))
def test_gauss_newton_cg_matches_jax(name):
    residual, x0, kw, precond = _gn_problems()[name]
    jx0 = jax.tree_util.tree_map(jnp.asarray, x0)
    tx0 = jax.tree_util.tree_map(_t, x0)
    jpre = None if precond is None else (lambda v: precond(jnp, v))
    tpre = None if precond is None else (lambda v: precond(torch, v))
    ref = jax.jit(lambda x: j_solvers.gauss_newton_cg(lambda v: residual(jnp, v), x,
                                                      precond=jpre, **kw))(jx0)
    got = t_solvers.gauss_newton_cg(lambda v: residual(torch, v), tx0, precond=tpre, **kw)
    _tree_close(got.x, ref.x)
    _close(got.losses, ref.losses)


@pytest.mark.parametrize("fletcher_reeves", [True, False])
@pytest.mark.parametrize("max_iter", [4, 50])
def test_cg_solve_matches_jax(fletcher_reeves, max_iter):
    """A pytree SPD system with a diagonal preconditioner; 50 iterations run
    far past convergence, where the guard freezes the iterate."""
    A1, b1 = _spd(6, 1)
    A2, b2 = _spd(4, 2)
    d = np.linspace(1.0, 3.0, 4).astype(np.float32)

    def op(xp, x):
        if xp is jnp:
            return {"a": A1 @ x["a"], "b": A2 @ x["b"]}
        return {"a": _t(A1) @ x["a"], "b": _t(A2) @ x["b"]}

    kw = dict(max_iter=max_iter, fletcher_reeves=fletcher_reeves)
    ref = jax.jit(lambda b: j_solvers.cg_solve(
        lambda x: op(jnp, x), b, precond=lambda v: {"a": v["a"], "b": v["b"] / d}, **kw))(
        {"a": jnp.asarray(b1), "b": jnp.asarray(b2)})
    got = t_solvers.cg_solve(lambda x: op(torch, x), {"a": _t(b1), "b": _t(b2)},
                             precond=lambda v: {"a": v["a"], "b": v["b"] / _t(d)}, **kw)
    assert np.all(np.isfinite(got.x["a"].numpy()))
    _tree_close(got.x, ref.x)
    _close(got.residual_norms, ref.residual_norms)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_descent_and_newton_solvers_match_jax(kind):
    """gradient_descent_l2, newton_cg and gradient_descent on a real or a
    complex least-squares problem."""
    A, b = _complex_system(2, 6, 3)
    if kind == "real":
        A, b = A.real.copy(), b.real.copy()
    x0 = np.zeros(3, A.dtype)

    def res(xp, x):
        if kind == "real":
            return (A @ x - b) if xp is jnp else _t(A) @ x - _t(b)
        Ar, Ai, br, bi = (A.real.copy(), A.imag.copy(), b.real.copy(), b.imag.copy()) \
            if xp is jnp else (_t(A.real), _t(A.imag), _t(b.real), _t(b.imag))
        xr, xi = xp.real(x), xp.imag(x)
        re, im = Ar @ xr - Ai @ xi - br, Ar @ xi + Ai @ xr - bi
        return jax.lax.complex(re, im) if xp is jnp else torch.complex(re, im)

    def loss(xp, x):
        r = res(xp, x)
        return xp.sum(xp.real(r) ** 2 + xp.imag(r) ** 2) if kind == "complex" \
            else xp.sum(r ** 2)

    cases = [
        (j_solvers.gradient_descent_l2, t_solvers.gradient_descent_l2, res,
         dict(num_iter=20, step_length=0.05, momentum=0.5)),
        (j_solvers.newton_cg, t_solvers.newton_cg, loss,
         dict(num_newton_iter=2, num_cg_iter=6, hessian_reg=0.1)),
        (j_solvers.gradient_descent, t_solvers.gradient_descent, loss,
         dict(num_iter=20, step_length=0.05, momentum=0.3)),
    ]
    for j_fn, t_fn, f, kw in cases:
        ref = jax.jit(lambda x: j_fn(lambda v: f(jnp, v), x, **kw))(jnp.asarray(x0))
        got = t_fn(lambda v: f(torch, v), _t(x0), **kw)
        _close(got.x, ref.x)
        _close(got.losses, ref.losses)


# ---------------------------------------------------------------- Fourier series

@pytest.mark.parametrize("h,w", [(7, 7), (8, 6), (5, 8)])
def test_fourier_matches_jax(h, w):
    rng = np.random.RandomState(h * 10 + w)
    a = rng.randn(2, 3, h, w).astype(np.float32)
    b = rng.randn(2, 3, h, w).astype(np.float32)
    shift = rng.randn(2, 1, 2).astype(np.float32)
    grid = (h + 4, w + 3)
    j_a = j_fourier.cfft2(jnp.asarray(a))
    t_a = t_fourier.cfft2(_t(a))
    j_b, t_b = j_fourier.cfft2(jnp.asarray(b)), t_fourier.cfft2(_t(b))
    _close(t_a, j_a)
    _close(t_fourier.cifft2(t_a), j_fourier.cifft2(j_a))
    _close(t_fourier.cifft2(t_a, (h + 2, w + 1)), j_fourier.cifft2(j_a, (h + 2, w + 1)))
    _close(t_fourier.pad_fs(t_a, grid), j_fourier.pad_fs(j_a, grid))
    _close(t_fourier.sample_fs(t_a), j_fourier.sample_fs(j_a))
    _close(t_fourier.sample_fs(t_a, grid), j_fourier.sample_fs(j_a, grid))
    _close(t_fourier.shift_fs(t_a, _t(shift)), j_fourier.shift_fs(j_a, jnp.asarray(shift)))
    _close(t_fourier.shift_fs(t_a, [0.3, -1.2]), j_fourier.shift_fs(j_a, [0.3, -1.2]))
    small = t_fourier.cfft2(_t(b[..., :h - 2, :w - 1]))
    j_small = j_fourier.cfft2(jnp.asarray(b[..., :h - 2, :w - 1]))
    _close(t_fourier.sum_fs([t_a, small]), j_fourier.sum_fs([j_a, j_small]))
    _close(t_fourier.inner_prod_fs(t_a, t_b), j_fourier.inner_prod_fs(j_a, j_b))


# ---------------------------------------------------------------- DCF helpers

@pytest.mark.parametrize("n", [6, 7])
def test_dcf_helpers_match_jax(n):
    m = n + 3
    _close(t_dcf.hann1d_uncentered(n), j_dcf.hann1d_uncentered(n))
    _close(t_dcf.hann2d_uncentered((n, m)), j_dcf.hann2d_uncentered((n, m)))
    for half in (False, True):
        _close(t_dcf.gauss_fourier(n, 1.3, half), j_dcf.gauss_fourier(n, 1.3, half))
    _close(t_dcf.label_function((n, m), (1.1, 0.7)), j_dcf.label_function((n, m), (1.1, 0.7)))
    center = np.array([[0.4, -1.3], [1.0, 0.5]], np.float32)
    _close(t_dcf.label_function_spatial((n, m), 1.2, _t(center), (1, 0)),
           j_dcf.label_function_spatial((n, m), 1.2, jnp.asarray(center), (1, 0)))
    f = np.linspace(-0.5, 0.5, 2 * n + 1).astype(np.float32)
    _close(t_dcf.cubic_spline_fourier(_t(f), -0.75), j_dcf.cubic_spline_fourier(f, -0.75))
    for method in ("ideal", "bicubic"):
        for centering in (False, True):
            for windowing in (False, True):
                got = t_dcf.get_interp_fourier((n, m), method, centering=centering,
                                               windowing=windowing)
                ref = j_dcf.get_interp_fourier((n, m), method, centering=centering,
                                               windowing=windowing)
                _close(got[0], ref[0])
                _close(got[1], ref[1])
    params = types.SimpleNamespace(reg_window_edge=3e-3, reg_window_min=1e-4,
                                   reg_window_power=2, reg_sparsity_threshold=0.05)
    tsz = np.array([n / 2.5, m / 3.0], np.float32)
    _close(t_dcf.get_reg_filter((n, m), _t(tsz), params),
           j_dcf.get_reg_filter((n, m), jnp.asarray(tsz), params))
    off = types.SimpleNamespace(use_reg_window=False, reg_window_min=2e-3)
    _close(t_dcf.get_reg_filter((n, m), _t(tsz), off),
           j_dcf.get_reg_filter((n, m), jnp.asarray(tsz), off))
    assert math.isclose(float(t_dcf.hann1d_uncentered(n)[0]), 1.0)
