"""Krylov solvers: PCG and mixed-precision iterative refinement.

Python loops where the reference has lax.while_loop / fori_loop; every
vector is a torch tensor on the solve's device. Convergence:
||r||_2 <= max(rtol * ||b||_2, atol), the PETSc KSP default the dataset's
per-case rtol/atol assume.

Port of pdebench_tpu/solvers/krylov.py (cg, refined_solve with the CG
inner, jacobi_preconditioner).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class KrylovInfo(NamedTuple):
    iterations: int
    residual: float
    converged: bool


def _tolerance(b: torch.Tensor, rtol: float, atol: float) -> float:
    return max(rtol * float(torch.linalg.norm(b)), atol)


def cg(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    maxiter: int = 10000,
):
    """Preconditioned conjugate gradients (SPD systems)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r
    tol = _tolerance(b, rtol, atol)

    x = x0
    r = b - A(x0)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    # divergence guard: a bad preconditioner must not burn maxiter
    blowup = 1e6 * (float(torch.linalg.norm(r)) + float(torch.linalg.norm(b)))
    k = 0
    rn = float(torch.linalg.norm(r))
    while k < maxiter and tol < rn < blowup:
        Ap = A(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
        rn = float(torch.linalg.norm(r))
    return x, KrylovInfo(k, rn, rn <= tol)


def refined_solve(
    A64: Callable,
    A32: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M32: Optional[Callable] = None,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    inner_iters: int = 30,
    max_outer: int = 60,
    inner_fwd: Optional[Callable] = None,
    inner_bwd: Optional[Callable] = None,
    inner_custom: Optional[Callable] = None,
):
    """Mixed-precision iterative refinement: f32 inner PCG, f64 outer.

    The outer loop computes exact f64 residuals r = b - A64 x and
    corrects x += z, where z approximately solves A z = r with
    `inner_iters` steps of f32 PCG (A32, preconditioned by M32). Each
    outer round contracts the error by the inner solve's reduction, so
    f64-level accuracy (rtol 1e-10) takes a handful of rounds while the
    iterations run in f32.

    inner_custom: full replacement for the inner solve (the fused
    GMG-PCG kernel, solvers/gmg_fused.py); receives and returns the
    inner_fwd-space f32 vector. inner_fwd/inner_bwd: a basis change
    applied once per outer round (dof -> lattice permutation, so the
    per-iteration inner work is gather-free).
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M32 is None:
        M32 = lambda r: r
    tol = _tolerance(b, rtol, atol)

    def inner_cg(r32):
        z = torch.zeros_like(r32)
        res = r32
        p = M32(res)
        rz = torch.dot(res, p)
        for _ in range(inner_iters):
            Ap = A32(p)
            denom = torch.dot(p, Ap)
            alpha = rz / torch.where(torch.abs(denom) > 0, denom, 1.0)
            z = z + alpha * p
            res = res - alpha * Ap
            s = M32(res)
            rz_new = torch.dot(res, s)
            beta = rz_new / torch.where(torch.abs(rz) > 0, rz, 1.0)
            p = s + beta * p
            rz = rz_new
        return z

    inner_solve = inner_custom if inner_custom is not None else inner_cg

    x = x0
    r = b - A64(x0)
    k = 0
    rn = float(torch.linalg.norm(r))
    rn_prev = 2.0 * rn
    stag = False
    while k < max_outer and rn > tol and not stag:
        r32 = r.to(torch.float32)
        if inner_fwd is not None:
            z32 = inner_bwd(inner_solve(inner_fwd(r32)))
        else:
            z32 = inner_solve(r32)
        x = x + z32.to(b.dtype)
        r = b - A64(x)
        rn = float(torch.linalg.norm(r))
        k += 1
        # stagnation: inner precision floor reached, no further progress
        stag = rn > 0.9 * rn_prev
        rn_prev = rn
    return x, KrylovInfo(k * inner_iters, rn, rn <= tol)


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    safe = torch.where(torch.abs(diag) > 1e-300, diag, 1.0)
    inv = 1.0 / safe
    return lambda r: inv * r
