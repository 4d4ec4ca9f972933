"""The plain float64 reference of the ADMM inner loop of the upstream 3D
driver (3d_admm.lua of MultigridShapeOpt/admm_optim), the pieces the
``r4-admm`` check rebuilds from the program's own iterates, and a whole
loop for small meshes that solves each Newton step directly.

Vertex fields are (3, V) float64; per-tet tensors are (3, 3, N) with
``T[c, k]`` the derivative of component c along axis k (the program's
``cell_grads`` convention, 3d_admm.lua's ``grad u``).  The loop, in the
order 3d_admm.lua and ``optim/admm.py`` take it, from u = 0, lambda = q =
0, Lambda = 0, for k = 1..K:

    q_k      = P_sigma(grad u_{k-1} + lambda_{k-1} / tau)       z-prox (3d_admm.lua:910)
    u_k      = argmin of the x-update with the load of (lambda_{k-1} - tau q_k),
               subject to g(u_k) = g(0) (Newton, 3d_admm.lua:940)
    lambda_k = lambda_{k-1} + tau (grad u_k - q_k)              dual update

with P_sigma the Frobenius projection onto {|T|_F <= sigma}.  The x-update's
stationarity residual is

    R = free (A_tau u + scaling J' + load(lambda_{k-1} - tau q_k) + sum_i Lambda_i B_i(u))

Sign conventions, each as ``optim/admm.py`` has them: the load enters R
with a plus sign (``r_lin = scaling J' free + tensor_rhs(lam - tau q)``),
Lambda multiplies +B (``Lu = A u + r_lin + Lambda . B``), the Newton step
is du = -st - sum_j dLambda_j t_j with dLambda = S^-1 (g - B . st), and
g(u) = g_raw(u) - g_raw(0): the volume and the unnormalized barycenter of
the deformed mesh less those of the undeformed one (4 constraints, the B_z
set-up of 3d_admm.lua:614-632).  ``A_tau`` is ``benchmark.reference``'s
operator with c_grad = tau.

Imports numpy, torch and ``benchmark.reference`` only: nothing of the
program, whose iterates it judges.  TF32 is turned off where it computes.
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference

CHUNK = 1 << 21  # tets a block of the per-tet passes


def _exact():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Tets:
    """Tetrahedra in a fixed order with their undeformed geometry: basis
    gradients g (N, 4, 3), volumes (N,), and the free mask (V,) of the
    vertices, all float64 on one device."""

    def __init__(self, coords, elems, free, device):
        _exact()
        self.mesh = reference.Mesh(coords, np.asarray(elems, dtype=np.int64), free, device)
        self.coords, self.elems, self.free = self.mesh.coords, self.mesh.elems, self.mesh.free
        self.g, self.vol = reference.basis(self.coords, self.elems)

    @property
    def n_vertices(self) -> int:
        return self.coords.shape[0]

    def blocks(self, chunk: int = CHUNK):
        for s in range(0, self.elems.shape[0], chunk):
            yield slice(s, s + chunk)


def patch_elements(gid: np.ndarray, class_offsets: np.ndarray) -> np.ndarray:
    """The tets of a brick-patch lattice in the order of a per-cell tensor
    (d, d, T, m, m, m, P) flattened: (T * m^3 * P, 4) vertex ids, tet
    (t, i, j, k, p) having the corners gid[p, (i, j, k) + class_offsets[t, a]].
    gid (P, m+1, m+1, m+1) is the patch set's vertex id of every site."""
    P, m = gid.shape[0], gid.shape[1] - 1
    i, j, k = np.meshgrid(*(np.arange(m),) * 3, indexing="ij")
    out = np.empty((len(class_offsets), m, m, m, P, 4), dtype=np.int64)
    for t, offs in enumerate(class_offsets):
        for a, o in enumerate(offs):
            out[t, ..., a] = np.moveaxis(gid[:, i + o[0], j + o[1], k + o[2]], 0, -1)
    return out.reshape(-1, 4)


def same_tets(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two (N, 4) tet lists hold the same tets, each vertex set
    once, in any order of tets and of corners."""
    if a.shape != b.shape:
        return False

    def canon(e):
        e = torch.sort(e.long(), dim=1).values
        for col in range(3, -1, -1):  # lexicographic by stable sorts, last key first
            e = e[torch.sort(e[:, col], stable=True).indices]
        return e

    return bool(torch.equal(canon(a), canon(b)))


def grads(tets: Tets, u: torch.Tensor) -> torch.Tensor:
    """grad u per tet, (3, 3, N): G[c, k] = sum_j u_c(v_j) dphi_j/dx_k."""
    out = torch.empty((3, 3, tets.elems.shape[0]), dtype=torch.float64, device=u.device)
    for s in tets.blocks():
        ue = u[:, tets.elems[s]]  # (c, n, j)
        out[:, :, s] = torch.einsum("cnj,njk->ckn", ue, tets.g[s])
    return out


def project_frobenius(Q: torch.Tensor, sigma: float) -> torch.Tensor:
    """Each (3, 3) tensor scaled onto the ball |T|_F <= sigma where it lies
    outside, unchanged inside."""
    nrm = torch.sqrt((Q * Q).sum(dim=(0, 1)))
    return torch.where(nrm > sigma, Q * (sigma / torch.where(nrm > sigma, nrm, torch.ones_like(nrm))), Q)


def z_prox(G_prev: torch.Tensor, lam_prev: torch.Tensor, tau: float, sigma: float) -> torch.Tensor:
    return project_frobenius(G_prev + lam_prev / tau, sigma)


def dual(lam_prev: torch.Tensor, G: torch.Tensor, q: torch.Tensor, tau: float) -> torch.Tensor:
    return lam_prev + tau * (G - q)


def load(tets: Tets, M: torch.Tensor) -> torch.Tensor:
    """int M : grad w over the mesh, (3, V): vertex j of a tet gets
    vol * sum_k M[c, k] dphi_j/dx_k."""
    r = torch.zeros((3, tets.n_vertices), dtype=torch.float64, device=M.device)
    for s in tets.blocks():
        t = torch.einsum("ckn,njk,n->cnj", M[:, :, s], tets.g[s], tets.vol[s])
        r.index_add_(1, tets.elems[s].reshape(-1), t.reshape(3, -1))
    return r


def _cof(A: torch.Tensor) -> torch.Tensor:
    """Cofactor matrices d det / dA of (n, 3, 3): row c is the cross product
    of the other two rows, in cyclic order."""
    cross = reference._cross
    return torch.stack([cross(A[:, 1], A[:, 2]), cross(A[:, 2], A[:, 0]), cross(A[:, 0], A[:, 1])], dim=1)


def _deformed(tets: Tets, u: torch.Tensor, s):
    """(A = I + grad u (n, 3, 3), det A (n,), centroid of x + u (n, 3)) of
    the tets in the block s."""
    e = tets.elems[s]
    ue = u[:, e]  # (c, n, j)
    A = torch.eye(3, dtype=torch.float64, device=u.device) + torch.einsum("cnj,njk->nck", ue, tets.g[s])
    det = (A[:, 0] * reference._cross(A[:, 1], A[:, 2])).sum(dim=1)
    cent = (tets.coords[e] + ue.permute(1, 2, 0)).mean(dim=1)
    return A, det, cent


def constraints(tets: Tets, u: torch.Tensor) -> torch.Tensor:
    """g_raw(u), (4,): the deformed volume sum vol det(I + grad u) and the
    unnormalized barycenter sum vol det(I + grad u) cent_j, j = x, y, z."""
    parts = []
    for s in tets.blocks():
        _, det, cent = _deformed(tets, u, s)
        w = tets.vol[s] * det
        parts.append(torch.cat([w.sum()[None], (w[:, None] * cent).sum(dim=0)]))
    return torch.stack(parts).sum(dim=0)


def constraint_grads(tets: Tets, u: torch.Tensor) -> torch.Tensor:
    """dg_raw/du, (4, 3, V), in closed form: with C = cof(I + grad u),
    B_vol = int C : grad w and B_j = int (C cent_j) : grad w + det e_j . w / 4
    (each corner carries a quarter of the tet's centroid)."""
    B = torch.zeros((4, 3, tets.n_vertices), dtype=torch.float64, device=u.device)
    for s in tets.blocks():
        e = tets.elems[s].reshape(-1)
        A, det, cent = _deformed(tets, u, s)
        gv = tets.g[s] * tets.vol[s][:, None, None]  # (n, j, k)
        CG = torch.einsum("nck,njk->cnj", _cof(A), gv)  # (c, n, j)
        B[0].index_add_(1, e, CG.reshape(3, -1))
        for j in range(3):
            t = CG * cent[:, j][None, :, None]
            t[j] += (tets.vol[s] * det / 4.0)[:, None]
            B[1 + j].index_add_(1, e, t.reshape(3, -1))
    return B


def stationarity(tets: Tets, coeffs, u, jp, scaling, load_k, Lambda) -> float:
    """|R| / |free (scaling J' + load_k)| with
    R = free (A_tau u + scaling J' + load_k + sum_i Lambda_i B_i(u))."""
    free = tets.free
    rhs = (scaling * jp + load_k) * free
    B = constraint_grads(tets, u) * free
    R = reference.apply_free(tets.mesh, u, coeffs) + rhs + torch.tensordot(Lambda.to(torch.float64), B, dims=1)
    return float(torch.linalg.vector_norm(R * free) / torch.linalg.vector_norm(rhs))


def constraint_scales(tets: Tets, g0: torch.Tensor) -> torch.Tensor:
    """What a constraint's defect is measured against: the volume for the
    volume, and volume x the mesh's largest |x_j| for the barycenter j
    (near 0 on a symmetric channel, so not its own value)."""
    ext = tets.coords.abs().max(dim=0).values
    return torch.cat([g0[:1].abs(), g0[0].abs() * ext])


def rebuild(tets: Tets, us: list, tau: float, sigma: float):
    """From the program's iterates u_1..u_K (vertex fields), the reference's
    (loads, q_K, lambda_K): loads[k-1] = load(lambda_{k-1} - tau q_k), the
    load the x-update of iteration k sees."""
    lam = torch.zeros((3, 3, tets.elems.shape[0]), dtype=torch.float64, device=tets.coords.device)
    G_prev = torch.zeros_like(lam)
    loads, q = [], None
    for u in us:
        q = z_prox(G_prev, lam, tau, sigma)
        loads.append(load(tets, lam - tau * q))
        G_prev = grads(tets, u)
        lam = dual(lam, G_prev, q, tau)
    return loads, q, lam


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, element by element."""
    return float((got.to(torch.float64) - want).abs().max() / want.abs().max().clamp_min(1e-300))


def readings(tets: Tets, coeffs, jp, samples: list, tau: float, sigma: float, scaling: float) -> dict:
    """The check's numbers over samples [(us, Lambdas, lam, q)], each a
    request's iterates u_k and Lambda_k and its final lambda and q as
    (3, 3, N) in the order of tets, all float64:
    lam_q_err, max over lambda_K and q_K of rel_err against the rebuilt
    ones; stationarity_max, over every iterate with the program's own
    Lambda_k; feasibility_max, |g_i(u_k) - g_i(0)| / constraint_scales,
    over every iterate and constraint."""
    _exact()
    g0 = constraints(tets, torch.zeros((3, tets.n_vertices), dtype=torch.float64, device=tets.coords.device))
    scale = constraint_scales(tets, g0)
    out = dict(lam_q_err=0.0, stationarity_max=0.0, feasibility_max=0.0)
    for (us, Lambdas, lam_p, q_p), j in zip(samples, jp):
        loads, q, lam = rebuild(tets, us, tau, sigma)
        out["lam_q_err"] = max(out["lam_q_err"], rel_err(lam_p, lam), rel_err(q_p, q))
        for u, L, ld in zip(us, Lambdas, loads):
            out["stationarity_max"] = max(out["stationarity_max"], stationarity(tets, coeffs, u, j, scaling, ld, L))
            feas = float(((constraints(tets, u) - g0).abs() / scale).max())
            out["feasibility_max"] = max(out["feasibility_max"], feas)
    return out


# ---------------------------------------------------------------------------
# the whole loop, for small meshes: every Newton step solved directly
# ---------------------------------------------------------------------------

def dense_operator(tets: Tets, coeffs) -> torch.Tensor:
    """A_tau as a dense (3V, 3V) matrix: the Jacobian of
    ``reference.apply``, by forward-mode differentiation."""
    def apply(x):
        return reference.apply(tets.mesh, x.reshape(3, -1), *coeffs).reshape(-1)

    return torch.func.jacfwd(apply)(torch.zeros(3 * tets.n_vertices, dtype=torch.float64, device=tets.coords.device))


def constraint_hessian(tets: Tets, u: torch.Tensor, Lambda: torch.Tensor) -> torch.Tensor:
    """sum_i Lambda_i d2 g_i / du2 at u, dense (3V, 3V): each tet's part of
    Lambda . g_raw as a function of its 12 unknowns, differentiated twice
    automatically (independent of the closed-form gradient), and summed
    into the rows and columns of its vertices."""
    eye = torch.eye(3, dtype=torch.float64, device=u.device)

    def energy(ue, x, g, vol):  # ue (3, 4) -> Lambda . (vol det A, vol det A cent)
        A = eye + ue @ g
        det = torch.dot(A[0], torch.linalg.cross(A[1], A[2]))
        cent = (x + ue.T).mean(dim=0)
        return vol * det * (Lambda[0] + torch.dot(Lambda[1:], cent))

    e = tets.elems
    He = torch.func.vmap(torch.func.hessian(energy))(u[:, e].permute(1, 0, 2), tets.coords[e], tets.g, tets.vol)
    V = tets.n_vertices
    dof = (torch.arange(3, device=u.device)[None, :, None] * V + e[:, None, :]).reshape(-1, 12)  # (n, c*4 + j)
    H = torch.zeros((3 * V, 3 * V), dtype=torch.float64, device=u.device)
    H.index_put_((dof[:, :, None].expand(-1, 12, 12), dof[:, None, :].expand(-1, 12, 12)), He.reshape(-1, 12, 12),
                 accumulate=True)
    return H


def loop(tets: Tets, coeffs, jp, tau: float, sigma: float, scaling: float, steps: int, ns_max_its: int,
         ns_tol: float) -> dict:
    """The ADMM loop from the zero state: K = steps iterations, each
    x-update a Newton on the KKT system with H = A_tau + sum Lambda_i g_i''
    solved directly on the free unknowns, stopped as the program stops it:
    |dLambda| <= ns_tol, or ns_max_its steps (then failed).  Returns the
    iterates us, Lambdas, Newton counts and the final lam and q."""
    _exact()
    dev = tets.coords.device
    A = dense_operator(tets, coeffs)
    free = tets.free.repeat(3).bool()  # (3V,), component-major as a (3, V) field flattens
    Aff = A[free][:, free]
    zero = torch.zeros((3, tets.n_vertices), dtype=torch.float64, device=dev)
    g0 = constraints(tets, zero)
    u, Lambda = zero, torch.zeros(4, dtype=torch.float64, device=dev)
    lam = torch.zeros((3, 3, tets.elems.shape[0]), dtype=torch.float64, device=dev)
    q = torch.zeros_like(lam)
    out = dict(us=[], Lambdas=[], newton=[], failed=False)
    for _ in range(steps):
        q = z_prox(grads(tets, u), lam, tau, sigma)
        r_lin = (scaling * jp + load(tets, lam - tau * q)) * tets.free
        done = False
        for it in range(ns_max_its):
            g = constraints(tets, u) - g0
            B = (constraint_grads(tets, u) * tets.free).reshape(4, -1)
            Lu = (A @ u.reshape(-1)).reshape(3, -1) * tets.free + r_lin + (Lambda @ B).reshape(3, -1)
            H = Aff + constraint_hessian(tets, u, Lambda)[free][:, free]
            rhs = torch.cat([Lu.reshape(1, -1), B])[:, free].T  # (n_free, 1 + 4)
            x = torch.linalg.solve(H, rhs)
            st, t = x[:, 0], x[:, 1:]
            S = B[:, free] @ t
            dLambda = torch.linalg.solve(S, g - B[:, free] @ st)
            du = torch.zeros(3 * tets.n_vertices, dtype=torch.float64, device=dev)
            du[free] = -st - t @ dLambda
            u = u + du.reshape(3, -1)
            Lambda = Lambda + dLambda
            if float(torch.linalg.vector_norm(dLambda)) <= ns_tol:
                done = True
                break
        out["newton"].append(it + 1)
        lam = dual(lam, grads(tets, u), q, tau)
        out["us"].append(u)
        out["Lambdas"].append(Lambda)
        if not done:
            out["failed"] = True
            break
    out["lam"], out["q"] = lam, q
    return out
