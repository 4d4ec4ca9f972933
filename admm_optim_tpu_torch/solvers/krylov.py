"""Preconditioned conjugate gradients (port of admm_optim_tpu/solvers/
krylov.py:19-80).

ConvCheck semantics as in the JAX package: stop when ||r|| <= abs_tol or
||r||/||r0|| <= rel_tol, or after max_iters; return the iterate, the
iteration count, the final residual norm and a convergence flag.  The
``lax.while_loop`` becomes a host loop that reads the residual norm each
iteration, as eager code must.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    res_norm: torch.Tensor
    converged: bool


def _vdot(x, y):
    return torch.sum(x * y)


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
    x, p, rz, it = x0, z, dot(r, z), 0
    while bool(nrm > tol) and it < max_iters:
        Ap = A(p)
        denom = dot(p, Ap)
        alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        p = z + beta * p
        rz = rz_new
        it += 1
        nrm = torch.sqrt(dot(r, r))
    return SolveResult(x, it, nrm, bool(nrm <= tol))
