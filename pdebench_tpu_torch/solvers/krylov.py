"""Krylov solvers: PCG, BiCGStab, restarted GMRES, MINRES and
mixed-precision iterative refinement.

Python loops where the reference has lax.while_loop / fori_loop; every
vector is a torch tensor on the solve's device. Convergence:
||r||_2 <= max(rtol * ||b||_2, atol), the PETSc KSP default the dataset's
per-case rtol/atol assume.

Port of pdebench_tpu/solvers/krylov.py (cg, bicgstab, gmres, minres,
refined_solve with its CG and GMRES inners, jacobi_preconditioner).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class KrylovInfo(NamedTuple):
    iterations: int
    residual: float
    converged: bool
    # outer restarts run (minres; 0 for the other solvers)
    restarts: int = 0


def _tolerance(b: torch.Tensor, rtol: float, atol: float) -> float:
    return max(rtol * float(torch.linalg.norm(b)), atol)


def _reductions(reduce: Optional[Callable]):
    """(dot, norm, dot_norm) of a solve: torch.dot and torch.linalg.norm
    on 1-D vectors, dot_norm(a, b, c) = (a . b, ||c||); or, with `reduce`
    (the sum over ranks of a tensor), the local sums over vectors of any
    shape summed by `reduce`, dot_norm's two in one call (stripe-sharded
    solves: parallel/halo.py; each call is a round trip between ranks)."""
    if reduce is None:
        return torch.dot, torch.linalg.norm, lambda a, b, c: (torch.dot(a, b), torch.linalg.norm(c))

    def local(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

    def dot(a, b):
        return reduce(local(a, b))

    def dot_norm(a, b, c):
        ab, cc = reduce(torch.stack([local(a, b), local(c, c)]))
        return ab, torch.sqrt(cc)

    return dot, lambda a: torch.sqrt(dot(a, a)), dot_norm


def cg(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    maxiter: int = 10000,
    reduce: Optional[Callable] = None,
):
    """Preconditioned conjugate gradients (SPD systems). `reduce`: see
    `_reductions` (None: 1-D vectors on one device)."""
    dot, norm, dot_norm = _reductions(reduce)
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r
    bn = float(norm(b))
    tol = max(rtol * bn, atol)

    x = x0
    r = b - A(x0)
    z = M(r)
    p = z
    rz, rn = dot_norm(r, z, r)
    rn = float(rn)
    # divergence guard: a bad preconditioner must not burn maxiter
    blowup = 1e6 * (rn + bn)
    k = 0
    while k < maxiter and tol < rn < blowup:
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new, rn = dot_norm(r, z, r)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
        rn = float(rn)
    return x, KrylovInfo(k, rn, rn <= tol)


def bicgstab(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    maxiter: int = 10000,
):
    """Preconditioned BiCGStab (nonsymmetric systems). Stops at the
    tolerance, at maxiter, or when rho or omega falls below 1e-300 in
    magnitude (breakdown)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r
    tol = _tolerance(b, rtol, atol)
    eps = 1e-300

    def guard(v):
        return torch.where(torch.abs(v) < eps, eps, v)

    x = x0
    r = b - A(x0)
    rhat = r
    p = v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    k = 0
    stag = False
    while k < maxiter and float(torch.linalg.norm(r)) > tol and not stag:
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / guard(rho)) * (alpha / guard(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / guard(torch.dot(rhat, v))
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        tt = torch.dot(t, t)
        omega = torch.dot(t, s) / torch.where(tt < eps, eps, tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        stag = bool(torch.abs(rho_new) < eps) or bool(torch.abs(omega) < eps)
        k += 1
    res = float(torch.linalg.norm(r))
    return x, KrylovInfo(k, res, res <= tol)


def gmres(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    maxiter: int = 2000,
    restart: int = 60,
):
    """Restarted GMRES(m) with left preconditioning, in b's dtype.

    Each cycle runs m = min(restart, n) Arnoldi steps with CGS2
    orthogonalization (classical Gram-Schmidt applied twice; rows of V
    beyond the current column are zero) and solves the small least
    squares by `lstsq_hessenberg`. The true residual ||b - A x|| is
    checked before every cycle; the count goes up by m a cycle."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r
    n = b.shape[0]
    m = min(restart, n)
    tol = _tolerance(b, rtol, atol)
    eps = torch.tensor(1e-300, dtype=b.dtype, device=b.device)

    def cycle(x):
        r = M(b - A(x))
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        V[0] = r / torch.where(beta < eps, eps, beta)
        for j in range(m):
            w = M(A(V[j]))
            h1 = V @ w
            w = w - V.T @ h1
            h2 = V @ w
            w = w - V.T @ h2
            H[:, j] += h1 + h2
            hn = torch.linalg.norm(w)
            H[j + 1, j] = hn
            V[j + 1] = w / torch.where(hn < eps, eps, hn)
        return x + V[:m].T @ lstsq_hessenberg(H, beta)

    x, k = x0, 0
    while k < maxiter and float(torch.linalg.norm(b - A(x))) > tol:
        x = cycle(x)
        k += m
    res = float(torch.linalg.norm(b - A(x)))
    return x, KrylovInfo(k, res, res <= tol)


def minres(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    maxiter: int = 10000,
    A32: Optional[Callable] = None,
    reduce: Optional[Callable] = None,
):
    """Preconditioned MINRES for symmetric (possibly indefinite) systems.

    The preconditioner M must be SPD (applied as M ~ P^{-1}). Lanczos with
    Givens rotations, the reference's recurrence term for term.

    The recurrence's residual estimate (phibar) is on the preconditioned
    residual and drifts from the true residual when M is applied in lower
    precision (f32 V-cycles), so a run can exit early believing it
    converged. Up to 4 outer restarts re-seed the Lanczos
    recurrence from the true f64 residual until it meets
    tol = rtol ||b|| + atol. A restart that does not lower the true
    residual keeps the best iterate and ends the solve (`stalled`: the
    next restart would repeat it). Each restart's recurrence runs while
    its own count is below `maxiter`; the restarts stop once the count
    over all of them reaches `maxiter`.

    With `A32` (an f32 twin of A), each restart's recurrence solves the
    correction equation in f32, M's output cast to f32 (MINRES-IR), 8
    restarts are allowed, and a restart asks phibar for at most a
    3e-7 relative reduction (what an f32 recurrence can close).

    The recurrence's scalars stay on the device; each iteration reads
    phibar once on the host, for the stop test. `reduce`: see
    `_reductions` (None: 1-D vectors on one device).
    """
    dot, norm, _ = _reductions(reduce)
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r
    restarts = 8 if A32 is not None else 4

    def run0(r, factor):
        """Lanczos from zero on the correction system A d = r, in r.dtype;
        stops when phibar has dropped by `factor`. Returns (d, k)."""
        dt = r.dtype
        A_in = A32 if A32 is not None else A
        eps = 1e-300 if dt == torch.float64 else 1e-30
        zero = torch.zeros((), dtype=dt, device=r.device)
        y = M(r).to(dt)
        beta1 = torch.sqrt(torch.clamp(dot(r, y), min=0.0))
        tol = float(beta1 * torch.tensor(factor, dtype=torch.float64).to(dt))
        x = torch.zeros_like(r)
        r1 = r2 = r
        w = w2 = torch.zeros_like(r)
        oldb, beta, dbar, epsln, phibar = zero, beta1, zero, zero, beta1
        cs, sn = zero - 1.0, zero
        k = 0
        while k < maxiter and float(phibar) > tol:
            beta_s = torch.clamp(beta, min=eps)
            v = y / beta_s
            yv = A_in(v).to(dt)
            if k >= 1:
                yv = yv - (beta / torch.clamp(oldb, min=eps)) * r1
            alfa = dot(v, yv)
            yv = yv - (alfa / beta_s) * r2
            r1, r2 = r2, yv
            y = M(yv).to(dt)
            oldb = beta
            beta = torch.sqrt(torch.clamp(dot(yv, y), min=0.0))

            oldeps = epsln
            delta = cs * dbar + sn * alfa
            gbar = sn * dbar - cs * alfa
            epsln = sn * beta
            dbar = -cs * beta

            gamma = torch.clamp(torch.sqrt(gbar * gbar + beta * beta), min=eps)
            cs = gbar / gamma
            sn = beta / gamma
            phi = cs * phibar
            phibar = sn * phibar

            w, w2 = (v - oldeps * w2 - delta * w) / gamma, w
            x = x + phi * w
            k += 1
        return x, k

    tol_true = float(norm(b)) * rtol + atol
    # the f32 recurrence can't close more than ~6 digits per restart
    floor = 3e-7 if A32 is not None else 0.0

    x = x0
    r = b - A(x0)
    res = float(norm(r))
    total = rs = 0
    stalled = False
    while res > tol_true and not stalled and rs < restarts and total < maxiter:
        # relative reduction still needed, mapped into phibar's norm
        factor = max(min(1.0, tol_true / max(res, 1e-300)), floor)
        if A32 is not None:
            d, k = run0(r.to(torch.float32), factor)
            d = d.to(b.dtype)
        else:
            d, k = run0(r, factor)
        x_new = x + d
        r_new = b - A(x_new)
        res_new = float(norm(r_new))
        total += k
        rs += 1
        # keep the best iterate: a restart that does not improve would
        # repeat the same inner solve, so it ends the loop
        stalled = not res_new < res
        if not stalled:
            x, r, res = x_new, r_new, res_new
    return x, KrylovInfo(total, res, res <= tol_true, rs)


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
    inner: str = "cg",
    inner_custom: Optional[Callable] = None,
):
    """Mixed-precision iterative refinement: f32 inner Krylov, f64 outer.

    The outer loop computes exact f64 residuals r = b - A64 x and
    corrects x += z, where z approximately solves A z = r with
    `inner_iters` f32 steps (A32, preconditioned by M32). Each outer
    round contracts the error by the inner solve's reduction, so
    f64-level accuracy (rtol 1e-10) takes a handful of rounds while the
    iterations run in f32.

    inner: "cg" (SPD: `inner_iters` PCG steps) or "gmres" (one
    `inner_iters`-step left-preconditioned Arnoldi cycle per outer round:
    the outer refinement IS the restart; Helmholtz and other indefinite
    or nonsymmetric systems). inner_custom: full replacement for the
    inner solve (the fused kernels, solvers/gmg_fused.py); receives and
    returns the inner_fwd-space f32 vector. inner_fwd/inner_bwd: a basis
    change applied once per outer round (dof -> lattice permutation, so
    the per-iteration inner work is gather-free).
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

    def inner_gmres(r32):
        """One m-step left-preconditioned Arnoldi cycle in f32.

        Orthogonalization is CGS2 (classical Gram-Schmidt, applied
        twice): h = V w, w -= V^T h, repeated. Rows of V beyond the
        current column are exactly zero, so no masking is needed. The
        (m+1, m) least squares goes through QR with an epsilon-guarded
        diagonal."""
        m = inner_iters
        eps32 = torch.tensor(1e-30, dtype=torch.float32, device=r32.device)
        g0 = M32(r32)
        beta = torch.linalg.norm(g0)
        V = torch.zeros((m + 1, r32.shape[0]), dtype=torch.float32, device=r32.device)
        H = torch.zeros((m + 1, m), dtype=torch.float32, device=r32.device)
        V[0] = g0 / torch.where(beta < eps32, eps32, beta)
        for j in range(m):
            w = M32(A32(V[j]))
            h1 = V @ w
            w = w - V.T @ h1
            h2 = V @ w
            w = w - V.T @ h2
            H[:, j] += h1 + h2
            hn = torch.linalg.norm(w)
            H[j + 1, j] = hn
            V[j + 1] = w / torch.where(hn < eps32, eps32, hn)
        return V[:m].T @ lstsq_hessenberg(H, beta)

    if inner_custom is not None:
        inner_solve = inner_custom
    elif inner == "cg":
        inner_solve = inner_cg
    elif inner == "gmres":
        inner_solve = inner_gmres
    else:
        raise ValueError(f"unknown inner {inner!r}")

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


def lstsq_hessenberg(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """y minimising ||beta e1 - H y|| for the (m+1, m) Hessenberg matrix
    of an Arnoldi cycle, in H's dtype: reduced QR, then the triangular
    solve with diagonal entries below 1e-30 in magnitude raised to 1e-30
    (a frozen or broken-down cycle leaves exact zeros there)."""
    eps = torch.tensor(1e-30, dtype=H.dtype, device=H.device)
    e1 = torch.zeros(H.shape[0], dtype=H.dtype, device=H.device)
    e1[0] = beta
    Q, R = torch.linalg.qr(H)
    rhs = Q.T @ e1
    diag_r = torch.diagonal(R)
    Rsafe = R + torch.diag(torch.where(torch.abs(diag_r) < eps, eps, 0.0))
    return torch.linalg.solve_triangular(Rsafe, rhs[:, None], upper=True)[:, 0]


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    safe = torch.where(torch.abs(diag) > 1e-300, diag, 1.0)
    inv = 1.0 / safe
    return lambda r: inv * r
