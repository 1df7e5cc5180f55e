"""Symbolic layer: case expressions -> numpy-evaluated callables + MMS calculus.

Every PDE case carries sympy-syntax strings for sources, coefficients,
boundary/initial conditions, and manufactured solutions in the variables
x, y, z, t. This module parses them once on the host and lambdifies them
with sympy's numpy printer. `lambdify_spatial` evaluates in float64 numpy
and hands the values over as a tensor on the caller's device;
`lambdify_numpy` stays in numpy (exact grids on the host).

Port of pdebench_tpu/fem/symbolic.py, whose `lambdify_spatial` printed
to jax.numpy; the expressions, parsing and MMS calculus are the same.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Sequence, Union

import numpy as np
import sympy as sp
import torch

X, Y, Z, T = sp.symbols("x y z t", real=True)
_LOCALS = {"x": X, "y": Y, "z": Z, "t": T, "pi": sp.pi}

ExprLike = Union[str, float, int, sp.Expr]


def parse(expr: ExprLike) -> sp.Expr:
    if isinstance(expr, sp.Expr):
        return expr
    if isinstance(expr, (int, float)):
        return sp.Float(float(expr))
    return _parse_str(expr)


@lru_cache(maxsize=2048)
def _parse_str(expr: str) -> sp.Expr:
    # sympify is tens of ms per expression and cases repeat expressions
    # heavily (the same u_exact on every BC side, MMS re-derivations,
    # reference_config re-solves) — memoize by source string
    return sp.sympify(expr, locals=_LOCALS)


def _host(points) -> np.ndarray:
    if isinstance(points, torch.Tensor):
        return points.detach().cpu().numpy()
    return np.asarray(points)


def lambdify_spatial(
    expr: ExprLike, dim: int, device, with_time: bool = False
) -> Callable:
    """Compile an expression to f(points[, t]) -> float64 tensor on `device`.

    `points` (numpy or tensor) has shape (..., dim); the result broadcasts
    to points[..., 0]. Evaluation runs in numpy on the host; the
    lambdified closure is memoized per (expr, dim, with_time).
    """
    fn = _lambdify_numpy_cached(parse(expr), dim, with_time)
    device = torch.device(device)

    if with_time:

        def call(points, t):
            return torch.as_tensor(fn(_host(points), float(t)), device=device)

    else:

        def call(points):
            return torch.as_tensor(fn(_host(points)), device=device)

    return call


def lambdify_numpy(expr: ExprLike, dim: int, with_time: bool = False) -> Callable:
    """Like lambdify_spatial but pure-numpy (for exact grids at f64 on host)."""
    return _lambdify_numpy_cached(parse(expr), dim, with_time)


@lru_cache(maxsize=1024)
def _lambdify_numpy_cached(e: sp.Expr, dim: int, with_time: bool) -> Callable:
    syms = [X, Y, Z][:dim] + ([T] if with_time else [])
    fn = sp.lambdify(syms, e, modules=["numpy"])

    def call(points, t=None):
        args = [points[..., d] for d in range(dim)]
        if with_time:
            args.append(t)
        out = fn(*args)
        return np.broadcast_to(np.asarray(out, dtype=np.float64),
                               points.shape[:-1]).copy()

    return call


def depends_on_t(expr: ExprLike) -> bool:
    return T in parse(expr).free_symbols


# ---------------------------------------------------------------------------
# MMS calculus (manufactured solutions -> derived data)
# ---------------------------------------------------------------------------


def _space_vars(dim: int):
    return [X, Y, Z][:dim]


def laplacian(u: sp.Expr, dim: int) -> sp.Expr:
    return sum(sp.diff(u, v, 2) for v in _space_vars(dim))


def grad(u: sp.Expr, dim: int) -> Sequence[sp.Expr]:
    return [sp.diff(u, v) for v in _space_vars(dim)]


def div(vec: Sequence[sp.Expr], dim: int) -> sp.Expr:
    return sum(sp.diff(f, v) for f, v in zip(vec, _space_vars(dim)))


def div_kappa_grad(u: sp.Expr, kappa: sp.Expr, dim: int) -> sp.Expr:
    """div(kappa * grad(u))."""
    return sum(
        sp.diff(kappa * sp.diff(u, v), v) for v in _space_vars(dim)
    )


def poisson_source(u: ExprLike, kappa: ExprLike, dim: int) -> sp.Expr:
    """f = -div(kappa grad u)  (reference: oracle/poisson.py:59-73)."""
    return sp.simplify(-div_kappa_grad(parse(u), parse(kappa), dim))


def heat_source(u: ExprLike, kappa: ExprLike, dim: int) -> sp.Expr:
    """f = u_t - div(kappa grad u)  (reference: oracle/heat.py:63-77)."""
    uu = parse(u)
    return sp.diff(uu, T) - div_kappa_grad(uu, parse(kappa), dim)
