"""P1 convection-diffusion element matrices for the NS velocity-block
preconditioner (port of admm_optim_tpu/ops/convdiff.py).

With w the frozen advecting velocity, elementwise

    A[i,j] = nu * vol * g_i.g_j  +  g_j . (sum_k mfac[i,k] w_k) * vol

(mfac the exact P1 mass factors), the same on each velocity component.
``art_diff`` adds first-order artificial diffusion |w|_e h_e / 2 to this
preconditioner operator only.  Layouts follow ops.geometry (element or
lattice axes last).
"""
from __future__ import annotations

import torch

from .geometry import corner_geometry, elem_geometry, p1_phys_grads


def _mfac(nl, d, like):
    m = torch.ones((nl, nl), dtype=torch.float64) + torch.eye(nl, dtype=torch.float64)
    return (m / ((d + 1) * (d + 2))).to(
        dtype=like.dtype, device=like.device
    )


def convdiff_corner_mats(cw, visc, art_diff=True, ncomp=None):
    """(C, C, nl, nl, ...) element matrices from stacked corner data for the
    patch-stencil assembly: cw (2d, nl, ...) holds corner positions (rows
    :d) and the advecting velocity at the corners (rows d:)."""
    d = cw.shape[0] // 2
    x, w = cw[:d], cw[d:]
    C = d if ncomp is None else ncomp
    nl = d + 1
    _, _, Jinv, vol = corner_geometry(x)
    g = p1_phys_grads(Jinv)  # (nl, d, ...)
    wbar = torch.einsum("ik,dk...->di...", _mfac(nl, d, cw), w)
    Cmat = torch.einsum("jd...,di...,...->ij...", g, wbar, vol)
    eyeC = torch.eye(C, dtype=cw.dtype, device=cw.device)
    if art_diff:
        h = vol ** (1.0 / d)
        wmag = torch.sqrt(torch.sum(w.mean(dim=1) ** 2, dim=0))
        nu_eff = visc + 0.5 * wmag * h
        K = torch.einsum("ia...,ja...,...->ij...", g, g, vol * nu_eff)
        return torch.einsum("cd,ij...->cdij...", eyeC, K + Cmat)
    K = torch.einsum("ia...,ja...->ij...", g, g) * vol
    return torch.einsum("cd,ij...->cdij...", eyeC, visc * K + Cmat)


def convdiff_elem_mats(coords, elems, w, visc, art_diff=True, ncomp=None):
    """(C, C, nl, nl, E) element matrices of nu_eff grad:grad + (w.grad u, v)
    on a mesh: coords (V, d), elems (E, nl) int64, w (d, V) at the vertices."""
    d = coords.shape[1]
    C = d if ncomp is None else ncomp
    nl = d + 1
    _, _, Jinv, vol = elem_geometry(coords, elems)
    g = p1_phys_grads(Jinv)  # (nl, d, E)
    K = torch.einsum("iae,jae->ije", g, g) * vol
    we = w[:, elems.T]  # (d, nl, E)
    wbar = torch.einsum("ik,dke->die", _mfac(nl, d, coords), we)
    Cmat = torch.einsum("jde,die,e->ije", g, wbar, vol)
    eyeC = torch.eye(C, dtype=coords.dtype, device=coords.device)
    if art_diff:
        h = vol ** (1.0 / d)
        wmag = torch.sqrt(torch.sum(we.mean(dim=1) ** 2, dim=0))
        nu_eff = visc + 0.5 * wmag * h
        K = torch.einsum("iae,jae,e->ije", g, g, vol * nu_eff)
        return torch.einsum("cd,ije->cdije", eyeC, K + Cmat)
    return torch.einsum("cd,ije->cdije", eyeC, visc * K + Cmat)
