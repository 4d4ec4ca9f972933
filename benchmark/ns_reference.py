"""A plain float64 reference of the steady incompressible Navier-Stokes
residual and drag that the r2-ns-newton cell checks the program against.

Plain torch in float64 (TF32 off while it computes), from the benchmark's own mesh arrays
(coords, elems, edges, elem_edges, subset_vertices, subset_edges); it
imports neither the program nor JAX.  The discretization is written out
from the equations:

* Taylor-Hood P2/P1 on tetrahedra.  Velocity nodes are the vertices, then
  the edge midpoints in the mesh's edge order; the pressure is P1 on the
  vertices.  The packed state is [v (3, V + Ne) component-major, p (V)].
* Momentum row of the velocity basis function w = phi_b e_c:
      nu (grad v, grad w) + ((v . grad) v, w) - (p, div w)
  divergence row of the pressure basis function psi_a: (div v, psi_a).
* Dirichlet rows v - g on the vertices and edges of inlet, wall and
  obstacle_surface; the outlet is do-nothing (no row replaced).  g is the
  inflow profile max(0, cos(pi r / 6)) in x, r = sqrt(y^2 + z^2) at the
  node, on the inlet's nodes, and zero elsewhere.
* Quadrature: the Grundmann-Moller rules of degree 5 (residual) and 3
  (drag), whose barycentric points and weights are written out below.
* Drag J = 1/2 nu int |grad v|^2 dx.

Where this departs from the upstream UG4 discretization: UG4 integrates
with its own Gauss rules per element order, and the upstream runs on
grids/box_3D_elongated.ugx, for which the benchmark's geomgen channel
stands in.  Both departures are the program's too, so the reference is
held to the program's discretization, not to UG4's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))  # local edge j joins corners TET_EDGES[j]
DIRICHLET = ("inlet", "wall", "obstacle_surface")
DIAMETER = 6.0
BLOCK = 65536  # elements a block

# Grundmann-Moller, degree 5: points (numerators, denominator), weight;
# the weights sum to 1, an integral is |T| * sum(w f(x_q))
QUAD5 = (
    [((5, 1, 1, 1), 8), ((1, 5, 1, 1), 8), ((1, 1, 5, 1), 8), ((1, 1, 1, 5), 8),
     ((3, 3, 1, 1), 8), ((3, 1, 3, 1), 8), ((3, 1, 1, 3), 8), ((1, 3, 3, 1), 8), ((1, 3, 1, 3), 8),
     ((1, 1, 3, 3), 8),
     ((3, 1, 1, 1), 6), ((1, 3, 1, 1), 6), ((1, 1, 3, 1), 6), ((1, 1, 1, 3), 6),
     ((1, 1, 1, 1), 4)],
    [32 / 105] * 10 + [-81 / 140] * 4 + [4 / 15],
)
# Grundmann-Moller, degree 3
QUAD3 = (
    [((3, 1, 1, 1), 6), ((1, 3, 1, 1), 6), ((1, 1, 3, 1), 6), ((1, 1, 1, 3), 6), ((1, 1, 1, 1), 4)],
    [9 / 20] * 4 + [-4 / 5],
)


def rule(quad) -> tuple[np.ndarray, np.ndarray]:
    """(barycentric points (nq, 4), weights (nq,)) of QUAD5 or QUAD3."""
    pts, w = quad
    return np.array([[k / d for k in num] for num, d in pts]), np.array(w)


class Mesh:
    """The NS wiring of one mesh level, from its arrays, on a device."""

    def __init__(self, level: dict, device):
        self.device = torch.device(device)
        V, Ne = len(level["coords"]), len(level["edges"])
        self.n_vertices, self.n_edges = V, Ne
        self.n_vel = V + Ne
        self.n_state = 3 * self.n_vel + V

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        self.elems = idx(level["elems"])
        self.edges = idx(level["edges"])
        self.dofs = torch.cat([self.elems, idx(level["elem_edges"]) + V], dim=1)  # (E, 10)
        fixed = np.zeros(self.n_vel, dtype=bool)
        for name in DIRICHLET:
            fixed[:V] |= level["subset_vertices"][name]
            fixed[V:] |= level["subset_edges"][name]
        inlet = np.concatenate([level["subset_vertices"]["inlet"], level["subset_edges"]["inlet"]])
        self.fixed = torch.as_tensor(fixed, device=self.device)
        self.inlet = torch.as_tensor(inlet, device=self.device)
        self.coords = torch.as_tensor(np.asarray(level["coords"], np.float64), device=self.device)
        self.quad5 = [torch.as_tensor(a, dtype=F64, device=self.device) for a in rule(QUAD5)]
        self.quad3 = [torch.as_tensor(a, dtype=F64, device=self.device) for a in rule(QUAD3)]

    def unpack(self, s):
        nv = 3 * self.n_vel
        return s[:nv].reshape(3, self.n_vel), s[nv:]

    def dof_coords(self, X) -> torch.Tensor:
        """(V + Ne, 3): the vertices, then the edge midpoints."""
        return torch.cat([X, 0.5 * (X[self.edges[:, 0]] + X[self.edges[:, 1]])], dim=0)

    def inlet_values(self, X) -> torch.Tensor:
        """g (3, n_vel): the inflow profile in x on the inlet's nodes."""
        xc = self.dof_coords(X)
        r = torch.sqrt(xc[:, 1] ** 2 + xc[:, 2] ** 2)
        prof = torch.clamp_min(torch.cos(math.pi * r / DIAMETER), 0.0)
        g = torch.zeros((3, self.n_vel), dtype=F64, device=self.device)
        g[0] = torch.where(self.inlet, prof, torch.zeros_like(prof))
        return g

    def cold_state(self, X) -> torch.Tensor:
        """Inlet data on the velocity, zero elsewhere and in the pressure."""
        return torch.cat([self.inlet_values(X).reshape(-1), X.new_zeros(self.n_vertices)])


def check_layout(mesh: Mesh, X, program_dof_coords) -> None:
    """Raises unless the program's velocity nodes (3, n_vel) sit where this
    file's layout puts them: the vertices, then the edge midpoints in the
    mesh's edge order."""
    got = torch.as_tensor(program_dof_coords, device=mesh.device).to(F64).T
    want = mesh.dof_coords(X.to(F64))
    if got.shape != want.shape:
        raise RuntimeError(f"the program's velocity nodes {tuple(got.shape)} are not the layout's {tuple(want.shape)}")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= 1e-5 * scale:
        raise RuntimeError(f"the program's velocity nodes are not the vertices then the edge midpoints: "
                           f"max distance {err:.3e}")


def _exact():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _geometry(X, elems):
    """(grad lambda (Eb, 4, 3), volume (Eb,)) of the tets."""
    x = X[elems]  # (Eb, 4, 3)
    J = (x[:, 1:] - x[:, :1]).transpose(1, 2)  # J[e, i, k] = d x_i / d xi_k
    det = torch.linalg.det(J)
    Jinv = torch.linalg.inv(J)  # rows: grad xi_k
    G = torch.cat([-Jinv.sum(dim=1, keepdim=True), Jinv], dim=1)
    return G, det.abs() / 6.0


def _p2(L, G):
    """P2 values (10,) and gradients (Eb, 10, 3) at the barycentric point L."""
    vals = [L[a] * (2.0 * L[a] - 1.0) for a in range(4)] + [4.0 * L[a] * L[b] for a, b in TET_EDGES]
    grads = [(4.0 * L[a] - 1.0) * G[:, a] for a in range(4)]
    grads += [4.0 * (L[a] * G[:, b] + L[b] * G[:, a]) for a, b in TET_EDGES]
    return torch.stack(vals), torch.stack(grads, dim=1)


def residual(mesh: Mesh, X, s, visc: float) -> torch.Tensor:
    """The packed residual (n_state,) in float64 on the mesh X (V, 3)."""
    _exact()
    X, s = X.to(device=mesh.device, dtype=F64), s.to(device=mesh.device, dtype=F64)
    v, p = mesh.unpack(s)
    r_mom = torch.zeros((mesh.n_vel, 3), dtype=F64, device=mesh.device)
    r_div = torch.zeros(mesh.n_vertices, dtype=F64, device=mesh.device)
    pts, wts = mesh.quad5
    for e0 in range(0, len(mesh.elems), BLOCK):
        el, dofs = mesh.elems[e0:e0 + BLOCK], mesh.dofs[e0:e0 + BLOCK]
        G, vol = _geometry(X, el)
        ve = v.T[dofs]  # (Eb, 10, 3): node, component
        pe = p[el]  # (Eb, 4)
        rm = torch.zeros_like(ve)
        rd = torch.zeros_like(pe)
        for L, wq in zip(pts, wts):
            phi, dphi = _p2(L, G)
            w = wq * vol  # (Eb,)
            vq = torch.einsum("b,ebc->ec", phi, ve)
            gradv = torch.einsum("ebc,ebd->ecd", ve, dphi)  # d v_c / d x_d
            pq = pe @ L
            div = gradv.diagonal(dim1=1, dim2=2).sum(-1)
            conv = torch.einsum("ed,ecd->ec", vq, gradv)  # (v . grad) v
            rm += w[:, None, None] * (visc * torch.einsum("ecd,ebd->ebc", gradv, dphi)
                                      + phi[None, :, None] * conv[:, None, :]
                                      - pq[:, None, None] * dphi)
            rd += (w * div)[:, None] * L[None, :]
        r_mom.index_add_(0, dofs.reshape(-1), rm.reshape(-1, 3))
        r_div.index_add_(0, el.reshape(-1), rd.reshape(-1))
    r_mom = r_mom.T
    r_mom = torch.where(mesh.fixed[None], v - mesh.inlet_values(X), r_mom)
    return torch.cat([r_mom.reshape(-1), r_div])


def drag(mesh: Mesh, X, s, visc: float) -> float:
    """J = 1/2 nu int |grad v|^2 dx, in float64."""
    _exact()
    X, s = X.to(device=mesh.device, dtype=F64), s.to(device=mesh.device, dtype=F64)
    v, _ = mesh.unpack(s)
    total = torch.zeros((), dtype=F64, device=mesh.device)
    pts, wts = mesh.quad3
    for e0 in range(0, len(mesh.elems), BLOCK):
        el, dofs = mesh.elems[e0:e0 + BLOCK], mesh.dofs[e0:e0 + BLOCK]
        G, vol = _geometry(X, el)
        ve = v.T[dofs]
        for L, wq in zip(pts, wts):
            _, dphi = _p2(L, G)
            gradv = torch.einsum("ebc,ebd->ecd", ve, dphi)
            total = total + torch.sum(wq * vol * (gradv ** 2).sum(dim=(1, 2)))
    return 0.5 * visc * float(total)


def readings(mesh: Mesh, visc: float, answers) -> dict:
    """The check's numbers over answers (X_i (V, 3), s_i, the program's
    drag), each the worst over them:
    ns_res_rel = |R(s_i; X_i)| / |R(s_cold; X_i)|, s_cold the inlet data;
    drag_err = |drag_program - J(s_i; X_i)| / |J(s_i; X_i)|."""
    res, derr = [], []
    for X, s, drag_prog in answers:
        X = X.to(device=mesh.device, dtype=F64)
        r = torch.linalg.vector_norm(residual(mesh, X, s, visc))
        r0 = torch.linalg.vector_norm(residual(mesh, X, mesh.cold_state(X), visc))
        res.append(_finite(float(r / r0)))
        j = drag(mesh, X, s, visc)
        derr.append(_finite(abs(float(drag_prog) - j) / abs(j)))
    return {"ns_res_rel": max(res), "drag_err": max(derr)}


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf
