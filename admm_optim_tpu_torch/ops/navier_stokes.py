"""Steady incompressible Navier-Stokes residual and drag (port of
admm_optim_tpu/ops/navier_stokes.py: NSSpace, vel_dof_coords,
inlet_values, ns_elem_residual, ns_residual, drag, diag_preconditioner,
pressure_mass_lumped).

Taylor-Hood P2/P1 Galerkin weak form
    nu*(grad v, grad w) + ((v.grad)v, w) - (p, div w) + (div v, psi) = 0
with the inlet profile max(0, cos(pi*|y_perp|/diameter)), no-slip on wall
and obstacle, and a do-nothing outlet.  The adjoint and the shape gradient
differentiate these functions with torch.autograd.

State is a packed vector s = [v (dim, n_vel) component-major, p (V)].
Element axes are LAST on every batched tensor, as in ops.geometry.

Every element -> dof sum (the residual's two, the lumped pressure mass, the
diagonal preconditioner's) goes through a sparsity.SegmentSum over all
elements (NSSpace.plans): on the GPU a fixed-order gather-sum, so that two
identical calls agree bit for bit, where index_add would add in atomic
order; on the CPU index_add_ in index order.  Both forms are plain
indexing and sums, so forward AD (the matrix-free Newton jvp) and double
backward (the J'' term of b2nd_order) pass through them.
"""
from __future__ import annotations

import dataclasses
import math
import types

import numpy as np
import torch

from ..core.mesh import MeshLevel
from ..core.quadrature import simplex_rule
from ..core.spaces import p1_tab, p2_elem_dofs, p2_tab
from .geometry import corner_geometry, elem_geometry, p1_phys_grads
from .sparsity import segment_plan


@dataclasses.dataclass
class NSSpace:
    """Static wiring for one mesh level (host numpy arrays; ``tables``
    gives them as tensors on a device, cached)."""

    dim: int
    vorder: int
    n_vertices: int
    n_vel: int  # velocity dofs per component
    elems: np.ndarray  # (E, d+1)
    edges: np.ndarray  # (Ne, 2)
    vel_dofs: np.ndarray  # (E, nbv) velocity element dofs
    vel_fixed: np.ndarray  # (n_vel,) bool - Dirichlet velocity dofs
    inlet: np.ndarray  # (n_vel,) bool - subset of fixed dofs with inflow data
    qw: np.ndarray
    val_v: np.ndarray  # (nq, nbv)
    gref_v: np.ndarray  # (nq, nbv, d)
    val_p: np.ndarray  # (nq, d+1)
    drag_qw: np.ndarray
    drag_gref_v: np.ndarray
    diameter: float = 6.0
    _cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def n_pressure(self) -> int:
        return self.n_vertices

    @property
    def n_state(self) -> int:
        return self.n_vel * self.dim + self.n_pressure

    @classmethod
    def build(
        cls,
        lvl: MeshLevel,
        vorder: int = 2,
        do_nothing: bool = True,
        quad_degree: int = 5,
        drag_quad_degree: int = 3,
        diameter: float = 6.0,
    ) -> "NSSpace":
        d = lvl.dim
        dir_names = ["inlet", "wall", "obstacle_surface"] + ([] if do_nothing else ["outlet"])
        vmask = lvl.vertex_mask(dir_names)
        inlet_v = lvl.subset_vertices["inlet"]
        if vorder == 2:
            vel_dofs = p2_elem_dofs(lvl)
            emask = np.zeros(len(lvl.edges), dtype=bool)
            for name in dir_names:
                emask |= lvl.subset_edges[name]
            vel_fixed = np.concatenate([vmask, emask])
            inlet = np.concatenate([inlet_v, lvl.subset_edges["inlet"]])
            n_vel = lvl.num_vertices + len(lvl.edges)
            val_v, gref_v = p2_tab(d, quad_degree)
            _, drag_gref_v = p2_tab(d, drag_quad_degree)
        elif vorder == 1:
            vel_dofs = lvl.elems.copy()
            vel_fixed = vmask.copy()
            inlet = inlet_v.copy()
            n_vel = lvl.num_vertices
            val_v, gref_v = p1_tab(d, quad_degree)
            _, drag_gref_v = p1_tab(d, drag_quad_degree)
        else:
            raise ValueError(f"unsupported velocity order {vorder}")
        _, qw = simplex_rule(d, quad_degree)
        val_p, _ = p1_tab(d, quad_degree)
        _, drag_qw = simplex_rule(d, drag_quad_degree)
        return cls(
            dim=d, vorder=vorder, n_vertices=lvl.num_vertices, n_vel=n_vel,
            elems=lvl.elems, edges=lvl.edges, vel_dofs=vel_dofs, vel_fixed=vel_fixed,
            inlet=inlet, qw=qw, val_v=val_v, gref_v=gref_v, val_p=val_p,
            drag_qw=drag_qw, drag_gref_v=drag_gref_v, diameter=diameter,
        )

    def tables(self, dtype, device):
        """The wiring and quadrature tables as tensors (index tables int64,
        masks bool, the rest in dtype) on device, built once per
        (dtype, device)."""
        key = (dtype, torch.device(device))
        if key not in self._cache:
            def idx(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=device)

            def real(a):
                return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

            self._cache[key] = types.SimpleNamespace(
                elems=idx(self.elems), edges=idx(self.edges), vel_dofs=idx(self.vel_dofs),
                vel_fixed=torch.as_tensor(self.vel_fixed, device=device),
                inlet=torch.as_tensor(self.inlet, device=device),
                qw=real(self.qw), val_v=real(self.val_v), gref_v=real(self.gref_v),
                val_p=real(self.val_p), drag_qw=real(self.drag_qw),
                drag_gref_v=real(self.drag_gref_v),
            )
        return self._cache[key]

    def plans(self):
        """(velocity, vertex) SegmentSums of element-local contributions,
        (nbv, E) into the n_vel velocity dofs and (d+1, E) into the
        vertices, flattened dof-major as ``vel_dofs.T`` and ``elems.T``
        (built once; each caches its tables per device)."""
        if "plans" not in self._cache:
            self._cache["plans"] = (
                segment_plan(np.asarray(self.vel_dofs).T.reshape(-1), self.n_vel),
                segment_plan(np.asarray(self.elems).T.reshape(-1), self.n_vertices),
            )
        return self._cache["plans"]

    # -- packing ---------------------------------------------------------
    def pack(self, v, p):
        """v (dim, n_vel) component-major, p (V,) -> flat state."""
        return torch.cat([v.reshape(-1), p])

    def unpack(self, s):
        nv = self.n_vel * self.dim
        return s[:nv].reshape(self.dim, self.n_vel), s[nv:]


def vel_dof_coords(space: NSSpace, coords):
    """(d, n_vel) positions of the velocity dofs on the current geometry."""
    if space.vorder == 1:
        return coords.T
    t = space.tables(coords.dtype, coords.device)
    mid = coords[t.edges].mean(dim=1)
    return torch.cat([coords, mid], dim=0).T


def inlet_values(space: NSSpace, coords):
    """(d, n_vel) Dirichlet data: cos-profile inflow in x, zero elsewhere."""
    t = space.tables(coords.dtype, coords.device)
    xc = vel_dof_coords(space, coords)  # (d, n_vel)
    r2 = torch.sum(xc[1:, :] ** 2, dim=0)
    # safe sqrt: grad(sqrt) is NaN at 0 (centerline dofs), and torch.where
    # passes that NaN on through the unselected branch; the double where
    # keeps the shape gradient through the vertex coordinates finite
    pos = r2 > 0
    r = torch.where(pos, torch.sqrt(torch.where(pos, r2, torch.ones_like(r2))), torch.zeros_like(r2))
    prof = torch.clamp_min(torch.cos(r * math.pi / space.diameter), 0.0)
    g0 = torch.where(t.inlet, prof, torch.zeros_like(prof))
    return torch.cat([g0[None], g0.new_zeros((space.dim - 1, space.n_vel))], dim=0)


# element block size: bounds the quadrature temporaries.  On the H100 at
# 3D refs=2 (86,016 elements, float32) the residual took 30.5 ms in 6
# blocks of the JAX package's TPU value 16384 and 5.6 ms in one, its jvp
# 54.0 and 14.2 ms, the vjp's apply 41.0 and 39.7 ms, at the same peak
# memory of a matrix-free adjoint (2.45 GiB above what it started from):
# host-bound, so one block up to 2^17 elements (PERF.md, PR 11)
NS_ELEM_CHUNK = 131072


def _elem_chunks(E: int):
    """(n_blocks, block): the JAX package's element blocking."""
    if E <= NS_ELEM_CHUNK:
        return 1, E
    nb = -(-E // NS_ELEM_CHUNK)
    return nb, -(-E // nb)


def _dfact(d):
    return 2.0 if d == 2 else 6.0


def ns_elem_residual(space: NSSpace, x, ve, pe, visc, stab: float = 0.0):
    """Element-local Galerkin residual from explicit corner positions.

    x (d, nl, B) corner coordinates; ve (d, nbv, B) local velocity dofs;
    pe (nl, B) local pressure dofs.  Returns (r_mom_e (d, nbv, B),
    r_div_e (nl, B)) before scatter and Dirichlet row replacement; the
    lattice Jacobian (ops.ns_patchjac) differentiates it per element."""
    d = space.dim
    t = space.tables(x.dtype, x.device)
    _, detJ, Jinv, vol = corner_geometry(x)
    gv = torch.einsum("qbr,rd...->qbd...", t.gref_v, Jinv)  # (nq, nbv, d, B)
    vq = torch.einsum("qb,cb...->cq...", t.val_v, ve)
    gradv = torch.einsum("qbd...,cb...->cdq...", gv, ve)
    pq = torch.einsum("qa,a...->q...", t.val_p, pe)
    divv = torch.diagonal(gradv, dim1=0, dim2=1).sum(-1)  # trace over (c, d)
    adet = detJ.abs()
    wdet = t.qw.reshape((-1,) + (1,) * adet.dim()) * adet[None] / _dfact(d)
    conv = torch.einsum("dq...,cdq...->cq...", vq, gradv)
    r_visc = visc * torch.einsum("q...,cdq...,qbd...->cb...", wdet, gradv, gv)
    r_conv = torch.einsum("q...,cq...,qb->cb...", wdet, conv, t.val_v)
    r_pres = -torch.einsum("q...,q...,qbc...->cb...", wdet, pq, gv)
    r_mom_e = r_visc + r_conv + r_pres  # (d, nbv, B)
    r_div_e = torch.einsum("q...,q...,qa->a...", wdet, divv, t.val_p)  # (nl, B)
    if stab != 0.0:
        # Brezzi-Pitkaranta: +stab * h_e^2 (grad p, grad psi)
        gp1 = p1_phys_grads(Jinv)
        gradp = torch.einsum("ad...,a...->d...", gp1, pe)
        h2 = vol ** (2.0 / d)
        r_div_e = r_div_e + stab * torch.einsum("...,d...,ad...->a...", h2 * vol, gradp, gp1)
    return r_mom_e, r_div_e


def ns_residual(space: NSSpace, coords, s, visc, stab: float = 0.0):
    """Packed Galerkin residual with Dirichlet rows replaced by (v - g).
    Elements go in NS_ELEM_CHUNK blocks (the JAX package's lax.map), whose
    contributions are summed into the dofs by NSSpace.plans."""
    d = space.dim
    t = space.tables(coords.dtype, coords.device)
    vplan, pplan = space.plans()
    v, p = space.unpack(s)
    E = t.elems.shape[0]
    _, block = _elem_chunks(E)
    rms, rds = [], []
    for e0 in range(0, E, block):
        el = t.elems[e0 : e0 + block].T  # (nl, Eb)
        vd = t.vel_dofs[e0 : e0 + block].T  # (nbv, Eb)
        x = coords.T[:, el]  # (d, nl, Eb)
        rm, rd = ns_elem_residual(space, x, v[:, vd], p[el], visc, stab)
        rms.append(rm)
        rds.append(rd)
    r_mom = vplan(torch.cat(rms, dim=-1).reshape(d, -1))
    r_div = pplan(torch.cat(rds, dim=-1).reshape(-1))
    g = inlet_values(space, coords)
    r_mom = torch.where(t.vel_fixed[None, :], v - g, r_mom)
    return space.pack(r_mom, r_div)


def drag(space: NSSpace, coords, s, visc):
    """J = 1/2 * nu * int |grad v|^2 dx."""
    d = space.dim
    t = space.tables(coords.dtype, coords.device)
    v, _ = space.unpack(s)
    _, detJ, Jinv, _ = elem_geometry(coords, t.elems)
    gv = torch.einsum("qbr,rde->qbde", t.drag_gref_v, Jinv)
    ve = v[:, t.vel_dofs.T]  # (c, nbv, E)
    gradv = torch.einsum("qbde,cbe->cdqe", gv, ve)
    wdet = t.drag_qw[:, None] * detJ.abs()[None, :] / _dfact(d)
    return 0.5 * visc * torch.einsum("qe,cdqe,cdqe->", wdet, gradv, gradv)


def diag_preconditioner(space: NSSpace, coords, visc):
    """Block-diagonal preconditioner: velocity ~ diag(nu*K + M), pressure ~
    lumped mass / nu (the Stokes Schur surrogate); the stepped drivers'
    default when no preconditioner is given."""
    d = space.dim
    t = space.tables(coords.dtype, coords.device)
    vplan, _ = space.plans()
    _, detJ, Jinv, _ = elem_geometry(coords, t.elems)
    gv = torch.einsum("qbr,rde->qbde", t.gref_v, Jinv)
    wdet = t.qw[:, None] * detJ.abs()[None, :] / _dfact(d)
    kdiag_e = torch.einsum("qe,qbde,qbde->be", wdet, gv, gv)
    mdiag_e = torch.einsum("qe,qb,qb->be", wdet, t.val_v, t.val_v)
    kdiag = vplan((visc * kdiag_e + mdiag_e).reshape(-1))
    kdiag = torch.where(t.vel_fixed, torch.ones_like(kdiag), kdiag)
    pdiag = pressure_mass_lumped(space, coords, visc)

    def M(r):
        rv, rp = space.unpack(r)
        return space.pack(rv / kdiag[None, :], rp / pdiag)

    return M


def pressure_mass_lumped(space: NSSpace, coords, visc):
    """(V,) lumped pressure mass / nu, the Stokes Schur-complement
    surrogate."""
    d = space.dim
    t = space.tables(coords.dtype, coords.device)
    _, pplan = space.plans()
    _, _, _, vol = elem_geometry(coords, t.elems)
    per = (vol[None, :] / (d + 1.0)).expand(t.elems.T.shape)
    return pplan(per.reshape(-1)) / visc
