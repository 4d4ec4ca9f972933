"""Deformation (x-update) operators, geometric constraint functionals and
ADMM proximal kernels on the global representation (port of
admm_optim_tpu/ops/deformation.py).

The extension form a(u,w) + tau*(grad u, grad w) as element matrices
``(C, C, nl, nl, ...)`` (``A[c, d, i, j]`` couples test dof (i, c) with
trial dof (j, d)); the constraint functionals g(u) (volume and barycenter
of the deformed domain, exact for P1 deformations), their gradients and
Hessian in closed form where the JAX package takes jacrev and
forward-over-reverse AD; the z-update projections and the dual ascent.
Vertex fields are ``(C, V)``, per-element tensors ``(d, d, E)``.  The
element -> vertex sums take an optional ``sparsity.SegmentSum`` over
``elems.T`` (``vertex_plan``), the fixed-order sum the global backend
uses; without one they are ``index_add``.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import corner_geometry, elem_geometry, gather_elem, p1_phys_grads, sdet
from .sparsity import segment_plan


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


def vertex_plan(elems: np.ndarray, n_vertices: int):
    """The SegmentSum of element-local contributions (..., nl, E) into
    vertices (..., V), for the fixed-order vertex sums below."""
    return segment_plan(np.asarray(elems).T.reshape(-1), n_vertices)


def vertex_sum(contrib, elems, n_vertices: int, plan=None):
    """(..., nl, E) element-local contributions -> (..., V) vertex sums."""
    flat = contrib.reshape(contrib.shape[:-2] + (-1,))
    if plan is not None:
        return plan(flat)
    out = flat.new_zeros(flat.shape[:-1] + (n_vertices,))
    return out.index_add_(out.dim() - 1, elems.T.reshape(-1), flat)


def volume_defect(coords, elems, u, ref_volume):
    """g_vol(u) = int det(I + grad u) dx - V_ref (VolumeDefect,
    2d_admm.lua:773,1122)."""
    G, vol = elem_grads_of(coords, elems, u)
    d = coords.shape[1]
    det = sdet(torch.eye(d, dtype=coords.dtype, device=coords.device)[:, :, None] + G)
    return torch.sum(vol * det) - ref_volume


def constraints(coords, elems, u, ref_volume, ref_barycenter):
    """g(u) in R^m, m = 1 + d: [volume defect, barycenter defects]."""
    ref_b = torch.as_tensor(ref_barycenter, dtype=coords.dtype, device=coords.device)
    return torch.cat([volume_defect(coords, elems, u, ref_volume).reshape(1),
                      barycenter(coords, elems, u) - ref_b])


def _constraint_state(coords, elems, u):
    """Per element: basis gradients g (nl, d, E), vol, A = I + grad u, its
    cofactor, det, the deformed centroid (d, E) and (C g_a)^c (C, nl, E)."""
    from .patchdeform import _cof

    d = coords.shape[1]
    _, _, Jinv, vol = elem_geometry(coords, elems)
    g = p1_phys_grads(Jinv)  # (nl, d, E)
    ue = u[:, elems.T]  # (C, nl, E)
    A = torch.eye(d, dtype=coords.dtype, device=coords.device)[:, :, None] + torch.einsum("cae,ake->cke", ue, g)
    cof = _cof(A)
    cent = (gather_elem(coords, elems) + ue).mean(dim=1)  # (d, E)
    Cg = torch.einsum("cke,ake->cae", cof, g)  # (C g_a)^c
    return g, vol, A, sdet(A), cent, Cg


def constraint_grads(coords, elems, u, ref_volume, ref_barycenter, free_mask, plan=None):
    """B (m, C, V): gradients of g with respect to u (C, V), Dirichlet rows
    zeroed; the closed form of the JAX package's jacrev:
    d g_vol / du_{c,a} = vol (C g_a)^c and d b_j / du_{c,a} =
    vol ((C g_a)^c cent_j + det delta_cj / nl)."""
    d = coords.shape[1]
    nl = d + 1
    g, vol, A, det, cent, Cg = _constraint_state(coords, elems, u)
    eye = torch.eye(d, dtype=coords.dtype, device=coords.device)
    rows = [vol * Cg]
    for j in range(d):
        rows.append(vol * (Cg * cent[j] + (det / nl) * eye[:, j, None, None]))
    B = vertex_sum(torch.stack(rows), elems, coords.shape[0], plan)  # (m, C, V)
    return B * free_mask[None]


def hvp_elem_mats(coords, elems, u, Lmbda):
    """(C, C, nl, nl, E) element matrices of the constraint Hessian
    sum_k Lambda_k d2g_k/du2 at the frozen Newton iterate (u, Lambda): the
    closed form of the per-element energy
    E_e(u) = vol det(A) (L0 + sum_j L_{1+j} cent_j), A = I + grad u,
      H[c,f,a,b] = vol [ S (dC/dA)[e_f (x) g_b]^{ck} g_a^k
                         + (C g_a)^c L_{1+f}/nl + L_{1+c}/nl (C g_b)^f ]
    with C = cof(A), S = L0 + sum_j L_{1+j} cent_j."""
    from .patchdeform import _dcof

    d = coords.shape[1]
    nl = d + 1
    g, vol, A, _, cent, Cg = _constraint_state(coords, elems, u)
    S = Lmbda[0] + sum(Lmbda[1 + j] * cent[j] for j in range(d))  # (E,)
    K = {}
    for f in range(d):
        for b in range(nl):
            Ef = torch.zeros_like(A)
            Ef[f] = g[b]  # e_f (x) g_b
            K[(f, b)] = torch.einsum("cke,ake->cae", _dcof(A, Ef), g)
    return torch.stack([
        torch.stack([
            torch.stack([
                torch.stack([
                    vol * (S * K[(f, b)][c, a] + Cg[c, a] * (Lmbda[1 + f] / nl) + (Lmbda[1 + c] / nl) * Cg[f, b])
                    for b in range(nl)
                ])
                for a in range(nl)
            ])
            for f in range(d)
        ])
        for c in range(d)
    ])  # (C, C, nl, nl, E)


def constraint_hvp(coords, elems, u, Lmbda, ref_volume, ref_barycenter, x, plan=None):
    """(sum_i Lambda_i d2g_i/du2) @ x (C, V), through hvp_elem_mats (the
    JAX package differentiates forward-over-reverse)."""
    H = hvp_elem_mats(coords, elems, u, Lmbda)
    return vertex_sum(torch.einsum("cfabe,fbe->cae", H, x[:, elems.T]), elems, coords.shape[0], plan)


def tensor_rhs(coords, elems, M, plan=None):
    """r (C, V): r[c, v] = int M : grad w dx for the per-element tensor
    M (d, d, E) with test function w = phi_v e_c (the lambda/q import
    terms of DeformationEquationRHS, 2d_admm.lua:437-456)."""
    _, _, Jinv, vol = elem_geometry(coords, elems)
    g = p1_phys_grads(Jinv)  # (nl, d, E)
    contrib = torch.einsum("e,cde,ide->cie", vol, M, g)  # (C, nl, E)
    return vertex_sum(contrib, elems, coords.shape[0], plan)


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


def max_frobenius_norm(coords, elems, u):
    """max_e ||grad u||_F (MaximumFrobeniusNorm, 2d_admm.lua:898)."""
    G, _ = elem_grads_of(coords, elems, u)
    return torch.max(torch.sqrt(torch.sum(G * G, dim=(0, 1))))


def max_spectral_norm(coords, elems, u):
    """max_e sigma_max(grad u) (MaxSpectralNorm, 2d_admm.lua:901)."""
    G, _ = elem_grads_of(coords, elems, u)
    if coords.shape[1] == 2:
        _, _, _, _, e1, e2 = _svals_2x2(G)
        return torch.max(e1 + e2)
    return torch.max(torch.linalg.svdvals(torch.movedim(G, -1, 0))[:, 0])


def z_update(coords, elems, u, lam, tau, sigma, norm_name="frobenius"):
    """q* = Proj_sigma(grad u |_e + lambda_e / tau), (d, d, E): the
    reference's MassModel solve and projection (2d_admm.lua:883-905) as
    exact elementwise arithmetic."""
    G, _ = elem_grads_of(coords, elems, u)
    Q = G + lam / tau
    if norm_name == "spectral":
        return project_spectral(Q, sigma)
    return project_frobenius(Q, sigma)


def dual_update(coords, elems, u, lam, q_proj, tau):
    """lambda <- lambda + tau*(grad u - q*); returns (new lam, increment)
    (LambdaUpdate, 2d_admm.lua:1181-1185)."""
    G, _ = elem_grads_of(coords, elems, u)
    inc = tau * (G - q_proj)
    return lam + inc, inc
