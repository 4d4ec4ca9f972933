"""Deformation / ADMM element ops on the brick-patch lattice layout (port of
admm_optim_tpu/ops/patchdeform.py).

Patch-space counterparts of the global element ops: every per-element
quantity becomes a per-(class, cell) quantity - elements of a brick
lattice are PARTITIONED across patches (unlike vertices, which are
duplicated), so cell reductions and elementwise tensor updates are exact
with no exchange.  Per-element tensor fields (lambda, q, grad u) are stored
as

    (d, d, T, *cells, P)      T = element classes (2 in 2D / 6 in 3D),
                              cells = (m,)^dim lattice cell boxes

All vertex-field access is static corner slicing (see ops.patchstencil).
The mesh's fixed cell geometry (basis gradients, volumes, corner
coordinates) is derived from the coordinates once, by cell_geometry, and
every op takes that value.
The constraint derivatives are the JAX package's closed cofactor forms;
its jacrev/jvp forms (constraint_grads_p, constraint_hvp_p) exist there
only as test references and are not ported.

Parity: the same reference plugin classes as the global ops
(DeformationEquationRHS, SecondDerivative*, MassModel, Testing,
LambdaUpdate - 2d_admm.lua:423-669, 883-905).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.patches import PatchSet
from .deformation import _svals_2x2, project_frobenius, project_spectral
from .geometry import corner_geometry, p1_phys_grads, sdet


def _cell_slice(cv, m):
    return tuple(slice(int(o), int(o) + m) for o in cv)


def class_corners(ps: PatchSet, x_p):
    """x_p (C, *lat, P) -> corner values (C, nl, T, *cells, P)."""
    m = x_p.shape[1] - 1
    pre = (slice(None),)
    per_class = [
        torch.stack([x_p[pre + _cell_slice(cv, m)] for cv in co], dim=1)
        for co in ps.class_offsets
    ]
    return torch.stack(per_class, dim=2)


class CellGeometry(NamedTuple):
    """The mesh's fixed per-cell geometry on the patch lattices."""

    g: torch.Tensor  # (nl, d, T, *cells, P) physical P1 basis gradients
    vol: torch.Tensor  # (T, *cells, P) cell volumes
    vol_valid: torch.Tensor  # vol masked by patch validity (vol itself unmasked)
    xc: torch.Tensor  # (d, nl, T, *cells, P) corner coordinates


def cell_geometry(ps: PatchSet, coords_p, pvalid=None) -> CellGeometry:
    """The geometry of coords_p (d, *lat, P) that every op of this module
    takes.  pvalid (P_local,) masks vol_valid, the weights of the
    reductions and of the constraint derivatives: padded dummy patches
    carry copies of patch 0's geometry and must not contribute
    (core.patches.pad_patchset)."""
    xc = class_corners(ps, coords_p)
    _, _, Jinv, vol = corner_geometry(xc)
    return CellGeometry(p1_phys_grads(Jinv), vol, vol if pvalid is None else vol * pvalid, xc)


def _grads(g, uc):
    """G[c, dd] = sum_i g[i, dd] uc[c, i] (the JAX package's unrolled sum
    order)."""
    nl, d = g.shape[0], g.shape[1]
    return torch.stack([
        torch.stack([sum(g[i, dd] * uc[c, i] for i in range(nl)) for dd in range(d)])
        for c in range(uc.shape[0])
    ])


def cell_grads(ps: PatchSet, geo: CellGeometry, u_p):
    """Per-cell gradient G (C, d, T, *cells, P) of a P1 field u_p (C, *lat, P)."""
    return _grads(geo.g, class_corners(ps, u_p))


def _corner_add(ps: PatchSet, contrib):
    """Additive (C, *lat, P) field from per-corner cell values contrib
    (C, nl, T, *cells, P): each corner adds into the cell box at its
    offset, in the JAX package's padded-sum order."""
    C, m = contrib.shape[0], contrib.shape[3]
    lat = (m + 1,) * ps.dim
    r = contrib.new_zeros((C,) + lat + contrib.shape[-1:])
    for t, co in enumerate(ps.class_offsets):
        for a in range(ps.dim + 1):
            r[(slice(None),) + _cell_slice(co[a], m)] += contrib[:, a, t]
    return r


def tensor_rhs_p(ps: PatchSet, geo: CellGeometry, M, masked=False):
    """Additive r (C, *lat, P): r = int M : grad w dx for per-cell tensor
    M (d, d, T, *cells, P), over the masked volumes if masked (the
    analytic constraint derivatives)."""
    dim, g = ps.dim, geo.g
    vol = geo.vol_valid if masked else geo.vol
    contrib = torch.stack([
        torch.stack([vol * sum(M[c, dd] * g[i, dd] for dd in range(dim)) for i in range(dim + 1)])
        for c in range(M.shape[0])
    ])  # (C, nl, T, *cells, P)
    return _corner_add(ps, contrib)


def _eye(d, like, ndim):
    return torch.eye(d, dtype=like.dtype, device=like.device).reshape((d, d) + (1,) * (ndim - 2))


def _cell_state(ps, geo, u_p):
    """Per cell A = I + grad u and cent = the corner mean of x + u."""
    uc = class_corners(ps, u_p)
    G = _grads(geo.g, uc)
    return _eye(ps.dim, G, G.dim()) + G, (geo.xc + uc).mean(dim=1)


def constraints_p(ps: PatchSet, geo: CellGeometry, u_p, ref_volume, ref_barycenter):
    """g(u) in R^m, m = 1 + d (exact; cells partitioned): the volume defect
    int det(I + grad u) dx - V_ref, then the barycenter defects
    b_i(u) - b_ref_i, b_i(u) = int (x_i + u_i) det(I + grad u) dx
    (unnormalized)."""
    A, cent = _cell_state(ps, geo, u_p)
    w = geo.vol_valid * sdet(A)  # (T, *cells, P)
    return torch.cat([
        (torch.sum(w) - ref_volume)[None],
        torch.sum(w * cent, dim=tuple(range(1, cent.dim()))) - ref_barycenter,
    ])


# ---------------------------------------------------------------------------
# analytic constraint derivatives (cofactor calculus)
#
#   g_vol(u)  = sum vol det(A),  A = I + grad u
#   g_bar_j(u)= sum vol det(A) cent_j(u),  cent = corner mean of x + u
#   d det(A)[E]      = cof(A) : E
#   d2 det(A)[E1,E2] = Dcof(A)[E2] : E1   (Dcof bilinear, symmetric)
# ---------------------------------------------------------------------------

# 3D cofactor entries: (sign, (a, b, c, e)) with cof[i][j] = sign * (A[a]A[b] - A[c]A[e])
_COF3 = (
    ((1, ((1, 1), (2, 2), (1, 2), (2, 1))), (-1, ((1, 0), (2, 2), (1, 2), (2, 0))),
     (1, ((1, 0), (2, 1), (1, 1), (2, 0)))),
    ((-1, ((0, 1), (2, 2), (0, 2), (2, 1))), (1, ((0, 0), (2, 2), (0, 2), (2, 0))),
     (-1, ((0, 0), (2, 1), (0, 1), (2, 0)))),
    ((1, ((0, 1), (1, 2), (0, 2), (1, 1))), (-1, ((0, 0), (1, 2), (0, 2), (1, 0))),
     (1, ((0, 0), (1, 1), (0, 1), (1, 0)))),
)


def _cof_from(r):
    """Stack the 3D cofactor pattern from the pair form r(a, b, c, e)."""
    return torch.stack([
        torch.stack([r(*idx) if sgn > 0 else -r(*idx) for sgn, idx in row]) for row in _COF3
    ])


def _cof(A):
    """Cofactor matrix d det/dA of (d, d, ...) stacks (matches sdet)."""
    if A.shape[0] == 2:
        return torch.stack([
            torch.stack([A[1, 1], -A[1, 0]]),
            torch.stack([-A[0, 1], A[0, 0]]),
        ])
    return _cof_from(lambda a, b, c, e: A[a] * A[b] - A[c] * A[e])


def _dcof(A, E):
    """Directional derivative Dcof(A)[E] (d/dt cof(A + tE) at t=0)."""
    if A.shape[0] == 2:
        return _cof(E)  # cof is linear in 2D

    def p(a, b):
        return A[a] * E[b] + E[a] * A[b]

    return _cof_from(lambda a, b, c, e: p(a, b) - p(c, e))


def scalar_rhs_p(ps: PatchSet, S):
    """Additive r (C, *lat, P) from per-cell scalars S (C, T, *cells, P):
    each cell adds S[c]/nl at every corner (the mass-like centroid term of
    the barycenter derivatives)."""
    nl = ps.dim + 1
    contrib = (S / nl)[:, None].expand((S.shape[0], nl) + S.shape[1:])
    return _corner_add(ps, contrib)


def _unit_rows(d, j, v):
    """(d, ...) stack that is v in row j and zero elsewhere (the JAX
    package's zeros(...).at[j].set(v))."""
    z = torch.zeros_like(v)
    return torch.stack([v if r == j else z for r in range(d)])


def constraint_grads_analytic_p(ps, geo, u_p, ref_volume, ref_barycenter):
    """ADDITIVE B (m, C, *lat, P) = dg/du, closed form:
    B_vol       = sum_cells vol cof(A)[c,b] g[i,b]
    B_bar_j     = sum_cells vol (cof(A)[c,b] g[i,b] cent_j + det(A) e_j/nl)."""
    d = ps.dim
    A, cent = _cell_state(ps, geo, u_p)
    cof = _cof(A)
    det = sdet(A)
    rows = [tensor_rhs_p(ps, geo, cof, masked=True)]
    for j in range(d):
        r = tensor_rhs_p(ps, geo, cof * cent[j], masked=True)
        rows.append(r + scalar_rhs_p(ps, _unit_rows(d, j, geo.vol_valid * det)))
    return torch.stack(rows)


def hvp_state_p(ps, geo, u_p, Lmbda):
    """(u, Lambda)-dependent cell state of the constraint HVP, computed
    once per Newton iterate (the HVP is applied at every Krylov matvec)."""
    A, cent = _cell_state(ps, geo, u_p)
    return (A, _cof(A), cent, Lmbda)


def constraint_hvp_apply_p(ps, geo, state, x_p):
    """ADDITIVE (sum_k Lambda_k d2g_k/du2) @ x at the precomputed state:
    h = sum vol [ (L0 Dcof(A)[Ex]
                   + sum_j L_{1+j} (Dcof(A)[Ex] cent_j + cof(A) cx_j))
                     : grad w
                 + sum_j L_{1+j} (cof(A):Ex) e_j . w/nl ]"""
    d = ps.dim
    A, cof, cent, Lmbda = state
    xc = class_corners(ps, x_p)
    Ex = _grads(geo.g, xc)
    cx = xc.mean(dim=1)  # (d, T, *cells, P)
    dc = _dcof(A, Ex)
    M = Lmbda[0] * dc
    cofEx = sum(cof[a, b] * Ex[a, b] for a in range(d) for b in range(d))
    for j in range(d):
        M = M + Lmbda[1 + j] * (dc * cent[j] + cof * cx[j])
    S = torch.stack([Lmbda[1 + j] * geo.vol_valid * cofEx for j in range(d)])
    return tensor_rhs_p(ps, geo, M, masked=True) + scalar_rhs_p(ps, S)


def constraint_hvp_analytic_p(ps, geo, u_p, Lmbda, ref_volume, ref_barycenter, x_p):
    """One-shot form (state recomputed inline); the solver path uses
    hvp_state_p + constraint_hvp_apply_p."""
    return constraint_hvp_apply_p(ps, geo, hvp_state_p(ps, geo, u_p, Lmbda), x_p)


def hvp_corner_block_fn(Lmbda):
    """Block-protocol corner matrices (ops.patchstencil.assemble_w) of the
    constraint Hessian sum_k Lambda_k d2g_k/du2 at a frozen Newton iterate.

    The per-cell energy behind the geometric constraints is
      E_cell(u) = vol0 * det(A(u)) * (L0 + sum_j L_{1+j} cent_j(u)),
    A = I + grad u, cent = mean of (X + u) corners - its corner-pair
    Hessian blocks are, with C = cof(A), S = L0 + sum_j L_{1+j} cent_j,
    g_a the physical P1 basis gradients and nl = d+1:
      blk(a,b)[c,f] = vol0 [ S * (dC/dA)[e_f (x) g_b]^{ck} g_a^k
                             + (C g_a)^c L_{1+f}/nl + L_{1+c}/nl (C g_b)^f ]
    (the same three terms constraint_hvp_apply_p applies matvec-side).
    Assembled into stencil slots once per Newton iterate, every Krylov
    H-matvec is one stencil apply.

    Corners arrive as stacked channels [coords | u] (2d, nl, *cells, P).
    assemble_w asks for one blk(a, b) at a time, so only one block's
    temporaries are alive.  Blocks are Hessian-symmetric
    (blk(a,b) = blk(b,a)^T), so sym=True half-stencil storage is valid."""

    def fn(xc):
        d = xc.shape[0] // 2
        x, u = xc[:d], xc[d:]
        nl = d + 1
        _, _, Jinv, vol = corner_geometry(x)
        g = p1_phys_grads(Jinv)  # (nl, d, *cells, P)
        A = _eye(d, g, g.dim()) + _grads(g, u)
        C = _cof(A)
        cent = (x + u).mean(dim=1)  # (d, *cells, P)
        S = Lmbda[0] + sum(Lmbda[1 + j] * cent[j] for j in range(d))

        def blk(a, b):
            Cga = [sum(C[c, k] * g[a, k] for k in range(d)) for c in range(d)]
            Cgb = [sum(C[f, k] * g[b, k] for k in range(d)) for f in range(d)]
            cols = []
            for f in range(d):
                # E = e_f (x) g_b  ->  dC = Dcof(A)[E]
                dC = _dcof(A, _unit_rows(d, f, g[b]))
                cols.append(torch.stack([
                    vol * (
                        S * sum(dC[c, k] * g[a, k] for k in range(d))
                        + Cga[c] * (Lmbda[1 + f] / nl)
                        + (Lmbda[1 + c] / nl) * Cgb[f]
                    )
                    for c in range(d)
                ]))
            return torch.stack(cols, dim=1)  # (c, f, *cells, P)

        return blk

    fn.block_protocol = True
    return fn


def z_update_p(ps, geo, u_p, lam, tau, sigma, norm_name="frobenius"):
    """q* = Proj_sigma(grad u + lambda/tau), per cell (d, d, T, *cells, P)."""
    Q = cell_grads(ps, geo, u_p) + lam / tau
    if norm_name == "spectral":
        d = ps.dim
        return project_spectral(Q.reshape(d, d, -1), sigma).reshape(Q.shape)
    return project_frobenius(Q, sigma)


def dual_update_p(ps, geo, u_p, lam, q_proj, tau):
    """lambda += tau*(grad u - q*); returns (new lam, increment)."""
    inc = tau * (cell_grads(ps, geo, u_p) - q_proj)
    return lam + inc, inc


def max_frobenius_norm_p(ps, geo, u_p, pvalid=None):
    G = cell_grads(ps, geo, u_p)
    n2 = torch.sum(G * G, dim=(0, 1))
    if pvalid is not None:
        n2 = n2 * pvalid
    return torch.max(torch.sqrt(n2))


def max_spectral_norm_p(ps, geo, u_p, pvalid=None):
    G = cell_grads(ps, geo, u_p)
    if pvalid is not None:
        G = G * pvalid
    if ps.dim == 2:
        _, _, _, _, e1, e2 = _svals_2x2(G)
        return torch.max(e1 + e2)
    d = ps.dim
    s = torch.linalg.svdvals(torch.movedim(G.reshape(d, d, -1), -1, 0))
    return torch.max(s[:, 0])


def l2_norm_p1_p(ps, geo, f_p):
    """sqrt(int |f|^2) for a consistent P1 patch field f (C, *lat, P)."""
    fc = class_corners(ps, f_p)  # (C, nl, T, *cells, P)
    nl = ps.dim + 1
    mfac = torch.as_tensor(
        (np.ones((nl, nl)) + np.eye(nl)) / ((ps.dim + 1) * (ps.dim + 2)),
        dtype=f_p.dtype, device=f_p.device,
    )
    val = torch.einsum("...,ij,ci...,cj...->", geo.vol_valid, mfac, fc, fc)
    return torch.sqrt(torch.clamp_min(val, 0.0))


def l2_norm_pc_p(ps, geo, T):
    """sqrt(int |T|^2) for a per-cell tensor field (d, d, T, *cells, P)."""
    return torch.sqrt(torch.clamp_min(torch.einsum("...,cd...,cd...->", geo.vol_valid, T, T), 0.0))
