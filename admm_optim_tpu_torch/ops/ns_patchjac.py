"""Assembled NS Jacobian on the brick-patch lattice (port of
admm_optim_tpu/ops/ns_patchjac.py).

P2 velocity dofs are the vertices of the once-refined lattice, so a
velocity Krylov vector is a dense ``(d, *lat_fine, P)`` array and the
local dofs of every level-k element sit at fixed lattice offsets per
element class: reads and writes are strided slices.  Per class the local
Jacobian blocks ``W[c]`` (nloc x nloc per cell) come from
``torch.func.jacfwd`` of the element residual (ops.navier_stokes
.ns_elem_residual), ``torch.func.vmap``-ed over JAC_CELL_CHUNK cells.
The apply is one batched (nloc x nloc) product per class plus the
additive -> consistent exchange; the transpose apply reuses W
with the contraction transposed (the adjoint's J^T).  The contractions
stay plain torch, as the JAX package leaves its einsums to XLA.

Memory: W is nclass*nloc^2 values per lattice cell (3D: 6*34^2).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.mesh import TET_EDGES, TRI_EDGES
from . import navier_stokes as nsops
from . import patchstencil as pst


@dataclasses.dataclass(frozen=True)
class NSJacWiring:
    """Static lattice wiring of the packed NS local dofs per element class:
    velocity component-major (c*nbv + b), then the d+1 pressure corners;
    velocity nodes are the corners then the edges in combinations order
    (core.spaces.p2_tab / p2_elem_dofs)."""

    dim: int
    nbv: int  # P2 nodes per element
    nl: int  # P1 corners per element (= dim+1)
    nclass: int
    vel_offs: tuple  # (nclass, nbv, dim) fine-lattice offsets in {0,1,2}
    p_offs: tuple  # (nclass, nl, dim) coarse-lattice offsets in {0,1}

    @property
    def nloc(self) -> int:
        return self.dim * self.nbv + self.nl


def build_wiring(ps) -> NSJacWiring:
    """Wiring from a level-k PatchSet (core.patches.build_patchset)."""
    d = ps.dim
    co = np.asarray(ps.class_offsets, dtype=np.int64)  # (nclass, nl, d)
    pairs = TET_EDGES if d == 3 else TRI_EDGES
    vel = np.concatenate([2 * co, co[:, pairs[:, 0]] + co[:, pairs[:, 1]]], axis=1)
    return NSJacWiring(
        dim=d,
        nbv=vel.shape[1],
        nl=co.shape[1],
        nclass=co.shape[0],
        vel_offs=tuple(tuple(tuple(int(x) for x in o) for o in cls) for cls in vel),
        p_offs=tuple(tuple(tuple(int(x) for x in o) for o in cls) for cls in co),
    )


def _vel_view_slices(off, m):
    """Strided fine-lattice slices selecting site 2t+off over cells t."""
    return tuple(slice(o, o + 2 * m - 1, 2) for o in off)


def _p_view_slices(off, m):
    return tuple(slice(o, o + m) for o in off)


def _gather_local(wiring: NSJacWiring, c: int, m: int, xv, xp):
    """(nloc, *cells, P) local dof array of class c from lattice fields
    xv (d, *lat_fine, P) and xp (1, *lat_coarse, P)."""
    rows = []
    for comp in range(wiring.dim):
        for b in range(wiring.nbv):
            rows.append(xv[(comp,) + _vel_view_slices(wiring.vel_offs[c][b], m)])
    for i in range(wiring.nl):
        rows.append(xp[(0,) + _p_view_slices(wiring.p_offs[c][i], m)])
    return torch.stack(rows, dim=0)


def _scatter_local(wiring: NSJacWiring, c: int, m: int, y_loc, yv, yp):
    """Accumulate (nloc, *cells, P) class contributions into the lattice
    fields yv, yp in place (strided views)."""
    k = 0
    for comp in range(wiring.dim):
        for b in range(wiring.nbv):
            yv[(comp,) + _vel_view_slices(wiring.vel_offs[c][b], m)] += y_loc[k]
            k += 1
    for i in range(wiring.nl):
        yp[(0,) + _p_view_slices(wiring.p_offs[c][i], m)] += y_loc[k]
        k += 1


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

# cells per jacfwd batch: bounds the (nq, nbv, d, B) temporaries.  On the
# H100 the refs=2 assembly (14,336 cells per class) took 257.5 ms in four
# batches of 4096 and 228.3 ms in one, at 1.22 and 2.46 GiB of peak
# temporaries (PERF.md); 65536 gave the same time in the same batch
# and would allow ~11 GB of temporaries at larger meshes.
JAC_CELL_CHUNK = 16384


def assemble_ns_jacobian(space, ps, wiring: NSJacWiring, coords_p, v0_p, p0_p, visc, stab: float = 0.0):
    """Per-class local Jacobian blocks at the frozen state (v0, p0).

    coords_p (d, *lat_coarse, P) level-k coordinates; v0_p (d, *lat_fine, P)
    the P2 velocity as a fine-lattice field; p0_p (1, *lat_coarse, P).
    Returns W (nclass, nloc, nloc, *cells, P): exact element Jacobians of
    the Galerkin residual (the Dirichlet rows live in the apply)."""
    d = wiring.dim
    m = ps.levels[-1].m
    nloc, nbv, nl = wiring.nloc, wiring.nbv, wiring.nl

    def f_single(u, x):
        """Local residual of ONE element: u (nloc,), x (d, nl)."""
        ve = u[: d * nbv].reshape(d, nbv)
        pe = u[d * nbv :]
        r_mom, r_div = nsops.ns_elem_residual(
            space, x[..., None], ve[..., None], pe[..., None], visc, stab
        )
        return torch.cat([r_mom.reshape(-1), r_div.reshape(-1)])

    jac_cells = torch.func.vmap(torch.func.jacfwd(f_single, argnums=0), in_dims=(-1, -1), out_dims=-1)
    Ws = []
    for c in range(wiring.nclass):
        x_c = torch.stack(
            [coords_p[(slice(None),) + _p_view_slices(wiring.p_offs[c][i], m)] for i in range(nl)],
            dim=1,
        )  # (d, nl, *cells, P)
        u0_c = _gather_local(wiring, c, m, v0_p, p0_p)  # (nloc, *cells, P)
        cells_shape = u0_c.shape[1:]
        B = int(np.prod(cells_shape))
        u0f = u0_c.reshape(nloc, B)
        xf = x_c.reshape(d, nl, B)
        nb = max(1, -(-B // JAC_CELL_CHUNK))
        block = -(-B // nb)
        Wc = torch.cat(
            [jac_cells(u0f[:, i : i + block], xf[:, :, i : i + block]) for i in range(0, B, block)],
            dim=-1,
        )  # (nloc, nloc, B)
        Ws.append(Wc.reshape((nloc, nloc) + cells_shape))
    return torch.stack(Ws, dim=0)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _apply_galerkin(wiring: NSJacWiring, m: int, W, xv, xp, transpose: bool):
    yv = torch.zeros_like(xv)
    yp = torch.zeros_like(xp)
    for c in range(wiring.nclass):
        x_loc = _gather_local(wiring, c, m, xv, xp)
        # the batched (nloc x nloc) matvec over cells as a broadcast product
        # and sum: an einsum would copy W[c] into a cells-major layout
        y_loc = (W[c] * x_loc[:, None]).sum(0) if transpose else (W[c] * x_loc[None]).sum(1)
        _scatter_local(wiring, c, m, y_loc, yv, yp)
    return yv, yp


def apply_ns_jacobian(ps, pre_ps, wiring: NSJacWiring, tab_f, tab_c, W, xv, xp):
    """y = J x on lattice fields: xv (d, *lat_fine, P), xp (1, *lat_coarse,
    P) consistent; tab_f/tab_c the LevelTables of the fine (NS-Dirichlet)
    and coarse levels.  Returns (yv, yp) consistent; Dirichlet velocity
    rows are identity (ns_residual's ``v - g`` rows)."""
    m = ps.levels[-1].m
    yv, yp = _apply_galerkin(wiring, m, W, xv, xp, transpose=False)
    yv = pst.exchange_sum(pre_ps.fine, yv, tab=tab_f)
    yp = pst.exchange_sum(ps.fine, yp, tab=tab_c)
    free = tab_f.free[None].to(xv.dtype)
    return free * yv + (1.0 - free) * xv, yp


def apply_ns_jacobian_t(ps, pre_ps, wiring: NSJacWiring, tab_f, tab_c, W, xv, xp):
    """y = J^T x.  With J = F + (I-F) J_g (F the Dirichlet row selector),
    J^T = F + J_g^T (I-F): zero the fixed entries of x, apply the
    transposed Galerkin blocks, add x back on the fixed entries."""
    m = ps.levels[-1].m
    free = tab_f.free[None].to(xv.dtype)
    yv, yp = _apply_galerkin(wiring, m, W, free * xv, xp, transpose=True)
    yv = pst.exchange_sum(pre_ps.fine, yv, tab=tab_f)
    yp = pst.exchange_sum(ps.fine, yp, tab=tab_c)
    return yv + (1.0 - free) * xv, yp


def make_bt_fn(space, ps, pre_ps, wiring: NSJacWiring, tab_f, tab_c=None):
    """(zp (n_p,), W) -> B^T zp (d, n_vel): the pressure-gradient coupling
    into the momentum rows from the stored velocity-pressure sub-blocks
    W[:, :d*nbv, d*nbv:]; fixed momentum rows are zero.  tab_c: the
    level-k tables, whose device gid saves the host table per call."""
    d, nbv, nl = wiring.dim, wiring.nbv, wiring.nl
    m = ps.levels[-1].m

    def bt(zp, W):
        if tab_c is None:
            xp = pst.to_patch(ps.fine, zp[None])
        else:
            xp = pst.to_patch_tab(tab_c, zp[None])
        yv = xp.new_zeros((d,) + tuple(tab_f.free.shape))
        for c in range(wiring.nclass):
            p_loc = torch.stack(
                [xp[(0,) + _p_view_slices(wiring.p_offs[c][i], m)] for i in range(nl)], dim=0
            )  # (nl, *cells, P)
            y_loc = (W[c, : d * nbv, d * nbv :] * p_loc[None]).sum(1)
            k = 0
            for comp in range(d):
                for b in range(nbv):
                    yv[(comp,) + _vel_view_slices(wiring.vel_offs[c][b], m)] += y_loc[k]
                    k += 1
        yv = pst.exchange_sum(pre_ps.fine, yv, tab=tab_f)
        yv = yv * tab_f.free[None].to(yv.dtype)
        return pst.from_patch_tab(tab_f, yv, space.n_vel, mode="owner")

    return bt


# ---------------------------------------------------------------------------
# global packed-state wrappers
# ---------------------------------------------------------------------------

def jac_memory_bytes(ps, wiring: NSJacWiring, itemsize: int = 4) -> int:
    m = ps.levels[-1].m
    cells = m**wiring.dim * ps.P
    return wiring.nclass * wiring.nloc**2 * cells * itemsize


def make_assemble_fn(space, ps, pre_ps, wiring: NSJacWiring, stab: float = 0.0):
    """(coords (V,d), s, visc) -> W, via the lattice representation."""

    def assemble(coords, s, visc):
        v0, p0 = space.unpack(s)
        return assemble_ns_jacobian(
            space, ps, wiring, pst.to_patch(ps.fine, coords.T), pst.to_patch(pre_ps.fine, v0),
            pst.to_patch(ps.fine, p0[None]), visc, stab,
        )

    return assemble


def make_matvec_fns(space, ps, pre_ps, wiring: NSJacWiring, tab_f, tab_c):
    """Packed-state (n_state,) -> (n_state,) matvecs (Jv, JTv), each taking
    (x, W)."""

    def to_lattice(x):
        xv, xp = space.unpack(x)
        return pst.to_patch_tab(tab_f, xv), pst.to_patch_tab(tab_c, xp[None])

    def from_lattice(yv_p, yp_p):
        yv = pst.from_patch_tab(tab_f, yv_p, space.n_vel, mode="owner")
        yp = pst.from_patch_tab(tab_c, yp_p, space.n_pressure, mode="owner")
        return space.pack(yv, yp[0])

    def jv(x, W):
        return from_lattice(*apply_ns_jacobian(ps, pre_ps, wiring, tab_f, tab_c, W, *to_lattice(x)))

    def jtv(x, W):
        return from_lattice(*apply_ns_jacobian_t(ps, pre_ps, wiring, tab_f, tab_c, W, *to_lattice(x)))

    return jv, jtv
