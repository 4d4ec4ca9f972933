"""Deformation (x-update) element operators: the constant SPD part
a(u,w) + tau*(grad u, grad w) of the extension bilinear form.

Port of admm_optim_tpu/ops/deformation.py:44-125 (element matrices),
:148-159 (the barycenter, the constraint target of the optimization step)
and :281-322 (the z-update projections); the other global-representation
constraint functionals come with the ELL backend.
Element matrices are ``(C, C, nl, nl, ...)`` with ``A[c, d, i, j]``
coupling test dof (i, c) with trial dof (j, d).
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import corner_geometry, elem_geometry, gather_elem, p1_phys_grads, sdet


def _mass_factors(nl, d, like):
    """Exact P1 mass: int l_i l_j = vol * (1 + delta_ij) / ((d+1)(d+2))."""
    m = (np.ones((nl, nl)) + np.eye(nl)) / ((d + 1) * (d + 2))
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


def deformation_corner_mats(x, c_eps, c_grad, c_mass):
    """(C, C, nl, nl, ...) element matrices from explicit corner positions
    x (d, nl, ...) in any trailing batch layout."""
    d = x.shape[0]
    nl = d + 1
    _, _, Jinv, vol = corner_geometry(x)
    g = p1_phys_grads(Jinv)  # (nl, d, ...)
    K = torch.einsum("ia...,ja...->ij...", g, g) * vol
    eyeC = torch.eye(d, dtype=x.dtype, device=x.device)
    cross = torch.einsum("id...,jc...,...->cdij...", g, g, vol)
    A = torch.einsum("cd,ij...->cdij...", (c_grad + 0.5 * c_eps) * eyeC, K)
    A = A + 0.5 * c_eps * cross
    A = A + c_mass * torch.einsum(
        "cd,ij,...->cdij...", eyeC, _mass_factors(nl, d, x), vol
    )
    return A


def deformation_corner_block_fn(c_eps, c_grad, c_mass):
    """Block protocol of deformation_corner_mats for
    patchstencil.assemble_w: fn(corners) -> blk with blk(a, b) =
    A[:, :, a, b] (C, C, *cells, P), computed on demand from the shared
    basis gradients so the (C, C, nl, nl, ...) tensor never exists."""

    def fn(x):
        d = x.shape[0]
        nl = d + 1
        _, _, Jinv, vol = corner_geometry(x)
        g = p1_phys_grads(Jinv)  # (nl, d, ...)
        mfac = (np.ones((nl, nl)) + np.eye(nl)) / ((d + 1) * (d + 2))

        def blk(a, b):
            K_ab = sum(g[a, r] * g[b, r] for r in range(d)) * vol
            diag = (c_grad + 0.5 * c_eps) * K_ab + (c_mass * float(mfac[a, b])) * vol
            rows = []
            for c in range(d):
                row = []
                for dd in range(d):
                    t = (0.5 * c_eps) * (g[a, dd] * g[b, c] * vol)
                    row.append(t + diag if c == dd else t)
                rows.append(torch.stack(row))
            return torch.stack(rows)

        return blk

    fn.block_protocol = True
    return fn


def deformation_elem_mats(coords, elems, c_eps, c_grad, c_mass):
    """(C, C, nl, nl, E) analytic P1 vector element matrices for
    c_eps*eps(u):eps(w) + c_grad*grad(u):grad(w) + c_mass*u.w;
    coords (V, d), elems (E, nl) int64."""
    d = coords.shape[1]
    nl = d + 1
    _, _, Jinv, vol = elem_geometry(coords, elems)
    g = p1_phys_grads(Jinv)  # (nl, d, E)
    K = torch.einsum("iae,jae->ije", g, g) * vol  # scalar stiffness (nl,nl,E)
    eyeC = torch.eye(d, dtype=coords.dtype, device=coords.device)
    # cross term of eps:eps -> A[c,d,i,j,e] += 0.5*c_eps * g[i,d,e]*g[j,c,e]*vol
    cross = torch.einsum("ide,jce,e->cdije", g, g, vol)
    A = torch.einsum("cd,ije->cdije", (c_grad + 0.5 * c_eps) * eyeC, K)
    A = A + 0.5 * c_eps * cross
    A = A + c_mass * torch.einsum(
        "cd,ij,e->cdije", eyeC, _mass_factors(nl, d, coords), vol
    )
    return A


# ---------------------------------------------------------------------------
# z-update prox (exact elementwise)
# ---------------------------------------------------------------------------

def elem_grads_of(coords, elems, u):
    """Per-element gradient of a P1 vector field u (C, V): (G (d, d, E)
    with G[c, d] = d_d u_c, vol (E,))."""
    _, _, Jinv, vol = elem_geometry(coords, elems)
    g = p1_phys_grads(Jinv)  # (nl, d, E)
    G = torch.einsum("ide,cie->cde", g, u[:, elems.T])
    return G, vol


def barycenter(coords, elems, u):
    """b_i(u) = int (x_i + u_i) det(I + grad u) dx (unnormalized, (d,));
    BarycenterDefect (2d_admm.lua:1123)."""
    G, vol = elem_grads_of(coords, elems, u)
    d = coords.shape[1]
    det = sdet(torch.eye(d, dtype=coords.dtype, device=coords.device)[:, :, None] + G)
    centroid = (gather_elem(coords, elems) + u[:, elems.T]).mean(dim=1)  # (d, E), exact for linear integrands
    return torch.einsum("e,ce->c", vol * det, centroid)


def project_frobenius(Q, sigma):
    """Project (d, d, ...) tensors onto the Frobenius ball of radius sigma.

    Parity: Testing(q_projected, q, ..., sigma) (2d_admm.lua:897)."""
    nrm = torch.sqrt(torch.sum(Q * Q, dim=(0, 1)))
    scale = torch.clamp_max(sigma / torch.clamp_min(nrm, 1e-30), 1.0)
    return Q * scale


def _svals_2x2(Q):
    a, b = Q[0, 0], Q[0, 1]
    c, dd = Q[1, 0], Q[1, 1]
    e1 = torch.sqrt((a + dd) ** 2 + (c - b) ** 2) * 0.5
    e2 = torch.sqrt((a - dd) ** 2 + (c + b) ** 2) * 0.5
    return a, b, c, dd, e1, e2


def project_spectral(Q, sigma):
    """Project (d, d, N) tensors onto the spectral-norm ball: clamp the
    singular values at sigma.

    Parity: ProjectWithSpectralNorm (2d_admm.lua:902).  2D uses the closed
    form via the rotation/reflection decomposition of 2x2 matrices; 3D a
    batched SVD (torch.linalg.svd, a library call outside any kernel, as
    the JAX package leaves it to XLA)."""
    d = Q.shape[0]
    if d == 2:
        a, b, c, dd, e1, e2 = _svals_2x2(Q)
        s1, s2 = e1 + e2, torch.abs(e1 - e2)  # singular values s1 >= s2 >= 0
        E = 0.5 * torch.stack([torch.stack([a + dd, b - c]), torch.stack([c - b, a + dd])])
        F = 0.5 * torch.stack([torch.stack([a - dd, b + c]), torch.stack([c + b, dd - a])])
        s1c = torch.clamp_max(s1, sigma)
        s2c = torch.clamp_max(s2, sigma)
        sgn = torch.sign(e1 - e2)
        e1c = 0.5 * (s1c + sgn * s2c)
        e2c = 0.5 * (s1c - sgn * s2c)
        one = torch.ones_like(e1)
        rE = torch.where(e1 > 1e-30, e1c / torch.clamp_min(e1, 1e-30), one)
        rF = torch.where(e2 > 1e-30, e2c / torch.clamp_min(e2, 1e-30), one)
        return E * rE + F * rF
    U, S, Vh = torch.linalg.svd(torch.movedim(Q, -1, 0))  # (N, d, d)
    out = torch.einsum("eij,ej,ejk->eik", U, torch.clamp_max(S, sigma), Vh)
    return torch.movedim(out, 0, -1)
