"""Geometric multigrid on refinement hierarchies with block-ELL level
operators (port of admm_optim_tpu/solvers/mg.py), the global backend's
V-cycle: Chebyshev smoothing for the SPD deformation operator, damped
Jacobi for the nonsymmetric conv-diff operators of the NS velocity block,
rediscretized coarse operators, and a dense level-0 inverse.

All level vectors are flat component-major ``(..., C*N_l)``; leading lane
axes pass through.  Transfers use the hierarchy invariant (core.mesh):
every fine vertex has parents (p0, p1) in the coarse level, p0 == p1 at a
coarse vertex, so prolongation is ``0.5*(x[p0] + x[p1])`` and restriction
its transpose.  Both are ``sparsity.linear_call``s of each other, and every
spmv of a cycle with ``vals_t`` is ``spmv_flat_pair``: autograd of a cycle
(the adjoint's transposed preconditioner) replays gathers only, never a
scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..ops import sparsity
from ..ops.sparsity import Pattern


@dataclasses.dataclass(eq=False)
class Transfer:
    """Static wiring between level l (fine) and l-1 (coarse): parents (Vf, 2)
    and the restriction's SegmentSum."""

    parents: np.ndarray  # (Vf, 2) int
    n_coarse: int
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        p = np.asarray(self.parents, np.int64)
        self.plan = sparsity.segment_plan(np.concatenate([p[:, 0], p[:, 1]]), self.n_coarse)

    def parents_t(self, device):
        key = torch.device(device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(np.asarray(self.parents, np.int64), device=device)
        return self._dev[key]

    def _prolong(self, xc, C):
        lead = xc.shape[:-1]
        Xc = xc.reshape(lead + (C, -1))
        p = self.parents_t(xc.device)
        return (0.5 * (Xc[..., p[:, 0]] + Xc[..., p[:, 1]])).reshape(lead + (-1,))

    def _restrict(self, xf, C):
        lead = xf.shape[:-1]
        Xf = 0.5 * xf.reshape(lead + (C, -1))
        return self.plan(torch.cat([Xf, Xf], dim=-1)).reshape(lead + (-1,))

    def prolong(self, xc, C):
        """flat (..., C*Vc) -> (..., C*Vf)."""
        return sparsity.linear_call(lambda v: self._prolong(v, C), lambda v: self._restrict(v, C), xc)

    def restrict(self, xf, C):
        """The transpose of prolong: flat (..., C*Vf) -> (..., C*Vc)."""
        return sparsity.linear_call(lambda v: self._restrict(v, C), lambda v: self._prolong(v, C), xf)


@dataclasses.dataclass(frozen=True)
class MGStructure:
    """Static part: one Pattern per level; levels[0] is the COARSEST."""

    patterns: tuple
    n_levels: int
    pre_smooth: int = 3
    post_smooth: int = 3
    cheb_lower: float = 0.25  # smoothing interval [cheb_lower*lmax, lmax]
    smoother: str = "chebyshev"  # "chebyshev" (SPD) | "jacobi" (nonsymmetric)


@dataclasses.dataclass
class MGData:
    """Dynamic part (device tensors)."""

    vals: list  # per level: (C, C, K, N)
    diag: list  # per level: flat (C*N,)
    free: list  # per level: flat (C*N,) float mask (0 at Dirichlet dofs)
    parents: list  # per level l>=1: Transfer into level l-1
    lmax: list  # per level: 0-d Chebyshev upper bound
    base_inv: Any  # dense inverse of the level-0 operator
    # optional per-level values of A^T (sparsity.transpose_values): every
    # spmv of the cycle then carries the gather-based transpose
    vals_t: Any = None


def _spmv(pat, vals, vals_t, x):
    if vals_t is None:
        return sparsity.spmv_flat(pat, vals, x)
    return sparsity.spmv_flat_pair(pat, vals, vals_t, x)


def estimate_lmax(pat: Pattern, vals, diag, iters: int = 15):
    """Power iteration for lambda_max(D^-1 A) from the deterministic start
    vector sin(i) + 1, with a 10% safety margin; a 0-d tensor."""
    n = pat.n_flat
    x = torch.sin(torch.arange(n, dtype=vals.dtype, device=vals.device)) + 1.0
    inv_d = 1.0 / torch.clamp_min(diag, 1e-30)
    x = x / torch.sqrt(torch.dot(x, x))
    for _ in range(iters):
        y = inv_d * sparsity.spmv_flat(pat, vals, x)
        x = y / torch.clamp_min(torch.sqrt(torch.dot(y, y)), 1e-30)
    y = inv_d * sparsity.spmv_flat(pat, vals, x)
    return torch.dot(x, y) / torch.dot(x, x) * 1.1


def chebyshev_smooth(pat: Pattern, vals, diag, lmax, x, b, degree: int, lower: float,
                     x_is_zero: bool = False, vals_t=None):
    """Chebyshev(degree) iteration for A x = b preconditioned by diag on
    [lower*lmax, lmax]; x_is_zero skips the first spmv (A.0 = 0)."""
    lmin = lower * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    inv_d = 1.0 / torch.clamp_min(diag, 1e-30)
    r = b if x_is_zero else b - _spmv(pat, vals, vals_t, x)
    d_vec = (inv_d * r) / theta
    x = x + d_vec
    # rho_0 = delta/theta seeds the rho-recurrence (Saad Alg. 12.1)
    sigma_old = delta / theta if degree > 1 else 1.0
    for _ in range(degree - 1):
        z = inv_d * (b - _spmv(pat, vals, vals_t, x))
        sigma_new = 1.0 / (2.0 * theta / delta - sigma_old)
        d_vec = (2.0 * sigma_new / delta) * z + (sigma_new * sigma_old) * d_vec
        x = x + d_vec
        sigma_old = sigma_new
    return x


def jacobi_smooth(pat: Pattern, vals, diag, lmax, x, b, degree: int, omega: float = 0.7,
                  x_is_zero: bool = False, vals_t=None):
    """Damped Jacobi for the nonsymmetric conv-diff operators, the damping
    scaled by the power-iteration bound on D^-1 A."""
    inv_d = omega / (torch.clamp_min(diag, 1e-30) * torch.clamp_min(lmax, 1e-30))
    n = degree
    if x_is_zero and degree >= 1:
        x = x + inv_d * b
        n = degree - 1
    for _ in range(n):
        x = x + inv_d * (b - _spmv(pat, vals, vals_t, x))
    return x


def build_mg_data(struct: MGStructure, elem_mat_fn: Callable, fixed_masks: list, parents: list) -> MGData:
    """Assemble all levels: elem_mat_fn(level) -> (C, C, nl, nl, E);
    fixed_masks per level (C, N) bool tensors; parents per level l >= 1
    Transfer objects."""
    vals_l, diag_l, free_l, lmax_l = [], [], [], []
    for l, pat in enumerate(struct.patterns):
        vals = sparsity.bake_dirichlet(pat, sparsity.assemble_values(pat, elem_mat_fn(l)), fixed_masks[l])
        d = sparsity.diag_cn(pat, vals).reshape(-1)
        vals_l.append(vals)
        diag_l.append(d)
        free_l.append(1.0 - fixed_masks[l].to(vals.dtype).reshape(-1))
        lmax_l.append(estimate_lmax(pat, vals, d))
    base_inv = torch.linalg.inv(sparsity.to_dense(struct.patterns[0], vals_l[0]))
    return MGData(vals_l, diag_l, free_l, list(parents), lmax_l, base_inv)


def vcycle(struct: MGStructure, data: MGData, b, x0=None):
    """One V(pre,post)-cycle on the finest level; flat (..., C*N) vectors."""
    C = struct.patterns[0].block
    if struct.smoother == "jacobi":
        def smooth(pat, v, d, lm, x, bb, deg, xz, vt):
            return jacobi_smooth(pat, v, d, lm, x, bb, deg, x_is_zero=xz, vals_t=vt)
    else:
        def smooth(pat, v, d, lm, x, bb, deg, xz, vt):
            return chebyshev_smooth(pat, v, d, lm, x, bb, deg, struct.cheb_lower, x_is_zero=xz, vals_t=vt)

    def solve_level(l, b_l, x_l, x_zero=False):
        if l == 0:
            return b_l @ data.base_inv.T
        pat = struct.patterns[l]
        vt = data.vals_t[l] if data.vals_t is not None else None
        x_l = smooth(pat, data.vals[l], data.diag[l], data.lmax[l], x_l, b_l, struct.pre_smooth, x_zero, vt)
        r = (b_l - _spmv(pat, data.vals[l], vt, x_l)) * data.free[l]
        rc = data.parents[l - 1].restrict(r, C) * data.free[l - 1]
        ec = solve_level(l - 1, rc, torch.zeros_like(rc), x_zero=True)
        x_l = x_l + data.parents[l - 1].prolong(ec, C) * data.free[l]
        return smooth(pat, data.vals[l], data.diag[l], data.lmax[l], x_l, b_l, struct.post_smooth, False, vt)

    x_zero = x0 is None
    return solve_level(struct.n_levels - 1, b, torch.zeros_like(b) if x0 is None else x0, x_zero=x_zero)


def make_preconditioner(struct: MGStructure, data: MGData) -> Callable:
    """M(r) ~= A^-1 r: one V-cycle from a zero initial guess."""

    def M(r):
        return vcycle(struct, data, r)

    return M
