"""Preconditioned conjugate gradients and BiCGStab (port of
admm_optim_tpu/solvers/krylov.py:19-205).

ConvCheck semantics as in the JAX package: stop when ||r|| <= abs_tol or
||r||/||r0|| <= rel_tol, or after max_iters; return the iterate, the
iteration count, the final residual norm and a convergence flag.  The
``lax.while_loop`` becomes a host loop that reads one flag per iteration,
as eager code must.

Both solvers take a single right-hand side or a batch of lanes, and a lane
batch reproduces ``jax.vmap`` of the JAX solver: ``dot`` then returns one
value per lane, every scalar of the recurrence is a (B,) tensor, a lane
whose loop condition is false is frozen with ``torch.where``, and the loop
runs until no lane is active.  Budgets (``max_iters``) and tolerances are
per lane.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor  # int64, one per lane (0-d for a single solve)
    res_norm: torch.Tensor
    converged: torch.Tensor  # bool, one per lane


def _vdot(x, y):
    return torch.sum(x * y)


def _lane(s, x):
    """Per-lane scalars s (B,) (or 0-d) broadcast against fields x."""
    return s.reshape(s.shape + (1,) * (x.dim() - s.dim()))


def _freeze(active, n_active, new, old):
    """Keep the new values of active lanes and the old ones elsewhere;
    where every lane is active (always, for a single solve) the new values
    are taken as they are."""
    if n_active == active.numel():
        return new
    return tuple(torch.where(_lane(active, a), a, b) for a, b in zip(new, old))


def cg(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    max_iters: int = 2000,
    abs_tol: float = 1e-12,
    rel_tol: float = 0.0,
    dot: Callable | None = None,
) -> SolveResult:
    """dot: custom inner product (e.g. owner-weighted for duplicated
    brick-patch vectors, solvers.patch_mg); defaults to the plain sum."""
    if dot is None:
        dot = _vdot
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731
    r = b - A(x0)
    z = M(r)
    nrm = torch.sqrt(dot(r, r))
    tol = torch.clamp_min(rel_tol * nrm, abs_tol)
    rz = dot(r, z)
    it = torch.zeros(nrm.shape, dtype=torch.int64, device=nrm.device)
    x, p = x0, z
    while True:
        active = (nrm > tol) & (it < max_iters)
        n_active = int(active.sum())
        if n_active == 0:
            break
        Ap = A(p)
        denom = dot(p, Ap)
        alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
        x_n = x + _lane(alpha, p) * p
        r_n = r - _lane(alpha, Ap) * Ap
        z = M(r_n)
        rz_new = dot(r_n, z)
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        p_n = z + _lane(beta, p) * p
        x, r, p, rz, nrm = _freeze(
            active, n_active,
            (x_n, r_n, p_n, rz_new, torch.sqrt(dot(r_n, r_n))), (x, r, p, rz, nrm),
        )
        it = it + active
    return SolveResult(x, it, nrm, nrm <= tol)


def bicgstab(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    max_iters: int = 2000,
    abs_tol: float = 1e-12,
    rel_tol: float = 0.0,
    dot: Callable | None = None,
    restarts: int = 2,
    floor: float = 50.0,
) -> SolveResult:
    """Right-preconditioned BiCGStab, mirroring the reference's
    bicgstab+gmg linear solver preset.

    restarts: recurrence rounds within the shared max_iters budget; each
    round after the first restarts from the TRUE residual of the previous
    round's iterate, because the recurred residual drifts from it in f32.
    The convergence flag is taken on a true residual.

    floor: attainable-residual clamp, the target is
    max(abs_tol, rel_tol*|r0|, floor*eps*|b|), fixed by each lane's first
    round; floor=0 disables it."""
    if dot is None:
        dot = _vdot
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731

    def nrm_of(v):
        return torch.sqrt(dot(v, v))

    eps = torch.finfo(b.dtype).eps
    tol = None
    x = x0
    its_total = None
    for _ in range(max(1, restarts)):
        r0 = b - A(x)
        nrm0 = nrm_of(r0)
        if tol is None:  # first round's true residual defines the target
            tol = torch.clamp_min(rel_tol * nrm0, abs_tol)
            tol = torch.maximum(tol, floor * eps * nrm_of(b))
            its_total = torch.zeros(nrm0.shape, dtype=torch.int64, device=nrm0.device)
        x, its = _bicgstab_round(A, b, x, r0, nrm0, M, dot, nrm_of, tol, max_iters - its_total)
        its_total = its_total + its
    nrm_true = nrm_of(b - A(x))
    return SolveResult(x, its_total, nrm_true, nrm_true <= tol)


def _bicgstab_round(A, b, x, r, nrm, M, dot, nrm_of, tol, budget):
    """One BiCGStab recurrence from the given (true) initial residual."""
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones(nrm.shape, dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    it = torch.zeros(nrm.shape, dtype=torch.int64, device=b.device)
    ok = torch.ones(nrm.shape, dtype=torch.bool, device=b.device)
    # dtype-aware breakdown detection (1e-300 would never trigger in f32,
    # where everything below ~1e-38 flushes to zero)
    brk = _breakdown_eps(b.dtype)
    while True:
        active = (nrm > tol) & (it < budget) & ok
        n_active = int(active.sum())
        if n_active == 0:
            break
        rho_new = dot(rhat, r)
        beta = (rho_new / _safe(rho)) * (alpha / _safe(omega))
        p_n = r + _lane(beta, r) * (p - _lane(omega, v) * v)
        phat = M(p_n)
        v_n = A(phat)
        denom = dot(rhat, v_n)
        alpha_n = rho_new / _safe(denom)
        s = r - _lane(alpha_n, v_n) * v_n
        shat = M(s)
        t = A(shat)
        omega_n = dot(t, s) / _safe(dot(t, t))
        x_n = x + _lane(alpha_n, phat) * phat + _lane(omega_n, shat) * shat
        r_n = s - _lane(omega_n, t) * t
        bad = (torch.abs(rho_new) < brk) | (torch.abs(denom) < brk)
        x, r, p, v, rho, alpha, omega, nrm, ok = _freeze(
            active, n_active,
            (x_n, r_n, p_n, v_n, rho_new, alpha_n, omega_n, nrm_of(r_n), ~bad),
            (x, r, p, v, rho, alpha, omega, nrm, ok),
        )
        it = it + active
    return x, it


def _breakdown_eps(dtype):
    # well above the flush-to-zero threshold, far below any healthy scalar
    return torch.finfo(dtype).tiny * 1e4


def _safe(x):
    """x with every |x| below the breakdown threshold replaced by the
    threshold, keeping the sign."""
    t = torch.full_like(x, _breakdown_eps(x.dtype))
    return torch.where(torch.abs(x) < t, torch.where(x < 0, -t, t), x)
