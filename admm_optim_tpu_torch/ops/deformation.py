"""Deformation (x-update) element operators: the constant SPD part
a(u,w) + tau*(grad u, grad w) of the extension bilinear form.

Port of admm_optim_tpu/ops/deformation.py:44-125 (element matrices only;
the constraint functionals and proximal kernels come with the ADMM port).
Element matrices are ``(C, C, nl, nl, ...)`` with ``A[c, d, i, j]``
coupling test dof (i, c) with trial dof (j, d).
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import corner_geometry, elem_geometry, p1_phys_grads


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
