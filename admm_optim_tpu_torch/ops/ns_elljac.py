"""Assembled NS Jacobian on unstructured meshes (port of
admm_optim_tpu/ops/ns_elljac.py), the global backend's Newton, adjoint and
block-preconditioner coupling operator.

Per-element local Jacobian blocks come from ``torch.func.jacfwd`` of the
element residual (ops.navier_stokes.ns_elem_residual) at the frozen
iterate, ``torch.func.vmap``-ed over JAC_ELEM_CHUNK elements.  They are
stored ``W (E, nloc, nloc)``: the JAX package's ``(nloc, nloc, E)`` with the
element axis first, so that the apply is one batched matrix product that
reads W once (an einsum over a trailing element axis would copy W into
that layout on every call).  The apply is a gather of the nloc local dofs
per element, that product, and a fixed-order segment sum
(sparsity.SegmentSum) into the packed state; the transpose apply (the
adjoint's J^T) multiplies by the transposed blocks.  Dirichlet semantics
are ns_residual's row replacement: J = F + (I - F) J_g with F the
fixed-velocity rows, J^T = F + J_g^T (I - F).  The stored
velocity-pressure blocks give the block preconditioner's B^T and its
exact transpose B, wrapped as one sparsity.linear_call so that autograd
of the preconditioner (transpose_M) applies B.

Memory: W is nloc^2 values per element (3D Taylor-Hood: nloc = 3*10 + 4 =
34; 398 MB in float32 at 3D refs=2, 86,016 elements).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import navier_stokes as nsops
from .sparsity import linear_call, segment_plan

# elements per jacfwd batch: bounds the (nq, nbv, d, B) temporaries.  On
# the H100 the 3D refs=2 assembly (86,016 elements) took 228-234 ms in 21
# batches of 4096 (the JAX package's TPU value) at 1.62 GiB of peak
# temporaries, 223.5 ms in 6 of 16384 at 3.09 GiB, 225.0 ms in one at
# 11.04 GiB (PERF.md): the fastest, as the lattice's JAC_CELL_CHUNK
JAC_ELEM_CHUNK = 16384


@dataclasses.dataclass(eq=False)
class EllJacWiring:
    """Static (host) wiring: packed-state dof index per element-local dof,
    velocity component-major (c*nbv + b), then the d+1 pressure corners."""

    dim: int
    nbv: int
    nl: int
    E: int
    n_state: int
    loc_idx: np.ndarray  # (nloc, E) int into the packed state
    fixed_state: np.ndarray  # (n_state,) bool - Dirichlet rows (velocity)
    n_vel: int = 0
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def nloc(self) -> int:
        return self.dim * self.nbv + self.nl

    def tables(self, device):
        """Device tables and the segment sums (built once per device)."""
        key = torch.device(device)
        if key not in self._dev:
            d, nbv = self.dim, self.nbv
            idx = np.ascontiguousarray(self.loc_idx.T.astype(np.int64))  # (E, nloc)
            vel = idx[:, : d * nbv]
            pr = idx[:, d * nbv:] - d * self.n_vel
            t = dict(
                loc=torch.as_tensor(idx, device=device),
                vel=torch.as_tensor(vel, device=device),
                pr=torch.as_tensor(np.ascontiguousarray(pr), device=device),
                fixed=torch.as_tensor(self.fixed_state, device=device),
                vfix=torch.as_tensor(self.fixed_state[: d * self.n_vel], device=device),
            )
            if "plans" not in self._dev:
                self._dev["plans"] = (
                    segment_plan(idx.ravel(), self.n_state),
                    segment_plan(vel.ravel(), d * self.n_vel),
                    segment_plan(pr.ravel(), self.n_state - d * self.n_vel),
                )
            t["state_plan"], t["vel_plan"], t["p_plan"] = self._dev["plans"]
            self._dev[key] = t
        return self._dev[key]


def build_wiring(space) -> EllJacWiring:
    d = space.dim
    vel_dofs = np.asarray(space.vel_dofs)  # (E, nbv)
    elems = np.asarray(space.elems)  # (E, nl)
    E, nbv = vel_dofs.shape
    nl = elems.shape[1]
    vel = np.arange(d, dtype=np.int64)[:, None, None] * space.n_vel + vel_dofs.T[None, :, :]  # (d, nbv, E)
    pr = d * space.n_vel + elems.T  # (nl, E)
    loc_idx = np.concatenate([vel.reshape(d * nbv, E), pr], axis=0)
    fixed_state = np.concatenate([np.tile(np.asarray(space.vel_fixed), d), np.zeros(space.n_pressure, dtype=bool)])
    return EllJacWiring(dim=d, nbv=nbv, nl=nl, E=E, n_state=space.n_state, loc_idx=loc_idx.astype(np.int32),
                        fixed_state=fixed_state, n_vel=space.n_vel)


def jac_memory_bytes(wiring: EllJacWiring, itemsize: int = 4) -> int:
    return wiring.nloc ** 2 * wiring.E * itemsize


def assemble_ns_jacobian(space, wiring: EllJacWiring, coords, s, visc, stab: float = 0.0):
    """W (E, nloc, nloc): the exact per-element Jacobian blocks at
    (coords, s), jacfwd of the element-local residual in JAC_ELEM_CHUNK
    batches.  On the CPU a block is bit for bit the same in any batch; on
    the card the batch's size selects the batched products' kernels, and
    blocks of two batch sizes differ by ~3e-7 of max |W|."""
    d, nbv = wiring.dim, wiring.nbv
    t = wiring.tables(coords.device)
    elems = space.tables(coords.dtype, coords.device).elems
    x_all = coords[elems].permute(0, 2, 1)  # (E, d, nl)
    u_all = s[t["loc"]]  # (E, nloc)

    def f_single(u, x):
        """Local residual of one element: u (nloc,), x (d, nl)."""
        r_mom, r_div = nsops.ns_elem_residual(
            space, x[..., None], u[: d * nbv].reshape(d, nbv)[..., None], u[d * nbv:][..., None], visc, stab)
        return torch.cat([r_mom.reshape(-1), r_div.reshape(-1)])

    jac_batch = torch.func.vmap(torch.func.jacfwd(f_single, argnums=0), in_dims=(0, 0), out_dims=0)
    W = coords.new_empty((wiring.E, wiring.nloc, wiring.nloc))
    for e0 in range(0, wiring.E, JAC_ELEM_CHUNK):
        e1 = min(e0 + JAC_ELEM_CHUNK, wiring.E)
        W[e0:e1] = jac_batch(u_all[e0:e1], x_all[e0:e1])
    return W


def make_assemble_fn(space, wiring: EllJacWiring, stab: float = 0.0):
    def assemble(coords, s, visc):
        return assemble_ns_jacobian(space, wiring, coords, s, visc, stab)

    return assemble


def _bmv(W, x_loc):
    """(E, a, b) x (E, b) -> (E, a)."""
    return torch.matmul(W, x_loc.unsqueeze(-1)).squeeze(-1)


def make_matvec_fns(space, wiring: EllJacWiring):
    """Packed-state (n_state,) matvec closures (jv, jtv), each (x, W)."""

    def jv(x, W):
        t = wiring.tables(x.device)
        y = t["state_plan"](_bmv(W, x[t["loc"]]).reshape(-1))
        return torch.where(t["fixed"], x, y)

    def jtv(x, W):
        t = wiring.tables(x.device)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        xm = torch.where(t["fixed"], zero, x)
        y = t["state_plan"](_bmv(W.transpose(1, 2), xm[t["loc"]]).reshape(-1))
        return y + torch.where(t["fixed"], x, zero)

    return jv, jtv


def _bt_raw(wiring, zp, W):
    d, nbv = wiring.dim, wiring.nbv
    t = wiring.tables(zp.device)
    yv = t["vel_plan"](_bmv(W[:, : d * nbv, d * nbv:], zp[t["pr"]]).reshape(-1))
    yv = torch.where(t["vfix"], torch.zeros((), dtype=yv.dtype, device=yv.device), yv)
    return yv.reshape(d, wiring.n_vel)


def _b_raw(wiring, zv, W):
    d, nbv = wiring.dim, wiring.nbv
    t = wiring.tables(zv.device)
    zvf = torch.where(t["vfix"], torch.zeros((), dtype=zv.dtype, device=zv.device), zv.reshape(-1))
    return t["p_plan"](_bmv(W[:, : d * nbv, d * nbv:].transpose(1, 2), zvf[t["vel"]]).reshape(-1))


def make_bt_fn(space, wiring: EllJacWiring):
    """(zp (n_p,), W) -> B^T zp (d, n_vel): the pressure-gradient coupling
    into the momentum rows from the stored blocks W[:, :d*nbv, d*nbv:],
    fixed rows zeroed.  Its autograd transpose is make_b_fn's B."""

    def bt(zp, W):
        return linear_call(lambda z: _bt_raw(wiring, z, W), lambda ct: _b_raw(wiring, ct, W), zp)

    return bt


def make_b_fn(space, wiring: EllJacWiring):
    """(zv (d, n_vel), W) -> (B^T)^T zv (n_p,): the exact transpose of
    make_bt_fn's coupling (fixed velocity entries masked first)."""

    def b(zv, W):
        return linear_call(lambda z: _b_raw(wiring, z, W), lambda ct: _bt_raw(wiring, ct, W), zv)

    return b
