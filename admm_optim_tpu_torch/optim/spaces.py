"""Representation adapters for the ADMM solver (port of
admm_optim_tpu/optim/spaces.py).

optim.admm's Newton/ADMM logic is representation-agnostic; these adapters
bind it to a field layout:
  * GlobalOps - fields (C, V) global vectors, tensors (d, d, E); the
    block-ELL spmv and the solvers.mg V-cycle; any simplex mesh (.ugx).
  * PatchOps - fields (C, *lat, P) on brick-patch lattices, per-cell
    tensors (d, d, T, *cells, P): the stencil apply plus the duplicate-site
    exchange, the solvers.patch_mg V-cycle, owner-weighted inner products.
Every field method also takes a lane axis (B, C, ...), which the
x-update's batched Krylov solves use.  With ``struct.spmd`` set (and
pvalid the rank's slice of the patch-validity mask of a padded set) the
same PatchOps runs on one rank's patch block (parallel.patch_shard):
exchanges and dots take the sharded forms, reductions all-reduce, maxima
too, so optim.admm's loops decide on values every rank holds alike.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from ..ops import deformation as dfm
from ..ops import patchdeform as pdfm
from ..ops import patchstencil as pst
from ..ops import sparsity
from ..ops import stencil_kernels as sk
from ..solvers import mg as mgmod
from ..solvers import patch_mg as pmg


@dataclasses.dataclass
class GlobalOps:
    """Current-geometry operator bundle on the global representation."""

    struct: Any  # mg.MGStructure
    mgdata: Any  # mg.MGData
    coords: torch.Tensor  # (V, d)
    elems: torch.Tensor  # (E, nl) int64
    free: torch.Tensor  # (C, V) float mask
    vplan: Any = None  # sparsity.SegmentSum of elems.T (dfm.vertex_plan); None: index_add

    @property
    def dim(self):
        return self.coords.shape[1]

    @property
    def pattern(self):
        return self.struct.patterns[-1]

    def zeros_field(self, dtype):
        return self.coords.new_zeros((self.dim, self.coords.shape[0]), dtype=dtype)

    def zeros_tensor(self, dtype):
        d = self.dim
        return self.coords.new_zeros((d, d, self.elems.shape[0]), dtype=dtype)

    def A(self, x):
        return sparsity.spmv_cn(self.pattern, self.mgdata.vals[-1], x)

    def M(self, r):
        return mgmod.vcycle(self.struct, self.mgdata, r.reshape(r.shape[:-2] + (-1,))).reshape(r.shape)

    def dot(self, x, y):
        """One value per lane for (B, C, V), a 0-d tensor for (C, V)."""
        return torch.sum(x * y, dim=(-2, -1))

    def dot_batch(self, Xs, Ys):
        """(i, ...) x (j, ...) -> (i, j) Gram block in one pass."""
        return Xs.reshape(Xs.shape[0], -1) @ Ys.reshape(Ys.shape[0], -1).T

    def constraints(self, u, ref_volume, ref_barycenter):
        return dfm.constraints(self.coords, self.elems, u, ref_volume, ref_barycenter)

    def constraint_grads(self, u, ref_volume, ref_barycenter):
        return dfm.constraint_grads(self.coords, self.elems, u, ref_volume, ref_barycenter, self.free,
                                    plan=self.vplan)

    def constraint_hvp(self, u, Lmbda, ref_volume, ref_barycenter, x):
        return dfm.constraint_hvp(self.coords, self.elems, u, Lmbda, ref_volume, ref_barycenter,
                                  x * self.free, plan=self.vplan) * self.free

    def hvp_fn(self, u, Lmbda, ref_volume, ref_barycenter):
        """x -> (sum_k Lambda_k g_k'') x at the fixed Newton iterate, one
        field (C, V): constraint_hvp with its element matrices built once
        per iterate (the matvec of the x-update with b2nd_order's term)."""
        H = dfm.hvp_elem_mats(self.coords, self.elems, u, Lmbda)
        V = self.coords.shape[0]

        def apply(x):
            xe = (x * self.free)[:, self.elems.T]
            return dfm.vertex_sum(torch.einsum("cfabe,fbe->cae", H, xe), self.elems, V, self.vplan) * self.free

        return apply

    def hess_fn(self, u, Lmbda, ref_volume, ref_barycenter):
        """x -> (A + sum_k Lambda_k g_k'') x with the constraint Hessian
        assembled into the ELL values once per Newton iterate
        (dfm.hvp_elem_mats): every Krylov matvec is one spmv, for one
        field or all lanes.  Dirichlet rows and columns of the Hessian part
        are zeroed without a second unit diagonal (A's values carry it)."""
        pat = self.pattern
        vals_h = sparsity.assemble_values(pat, dfm.hvp_elem_mats(self.coords, self.elems, u * self.free, Lmbda))
        fixed = self.free == 0  # (C, V)
        mask = fixed[:, None, None, :] | fixed[:, pat.cols_t(fixed.device)][None]
        vals_H = self.mgdata.vals[-1] + torch.where(mask, torch.zeros((), dtype=vals_h.dtype, device=vals_h.device),
                                                    vals_h)
        return lambda x: sparsity.spmv_cn(pat, vals_H, x)

    def tensor_rhs(self, M):
        return dfm.tensor_rhs(self.coords, self.elems, M, plan=self.vplan) * self.free

    def grad_tensor(self, u):
        return dfm.elem_grads_of(self.coords, self.elems, u)[0]

    def z_update(self, u, lam, tau, sigma, norm_name):
        return dfm.z_update(self.coords, self.elems, u, lam, tau, sigma, norm_name)

    def dual_update(self, u, lam, q_proj, tau):
        return dfm.dual_update(self.coords, self.elems, u, lam, q_proj, tau)

    def max_grad_norm(self, u, norm_name):
        if norm_name == "spectral":
            return dfm.max_spectral_norm(self.coords, self.elems, u)
        return dfm.max_frobenius_norm(self.coords, self.elems, u)

    def norm_p1(self, f):
        from .admm import l2_norm_p1

        return l2_norm_p1(self.coords, self.elems, f)

    def norm_pc(self, T):
        from .admm import l2_norm_pc

        return l2_norm_pc(self.coords, self.elems, T)


@dataclasses.dataclass
class PatchOps:
    """Operator bundle on the brick-patch representation."""

    struct: Any  # pmg.PatchMGStructure
    data: Any  # pmg.PatchMGData (carries per-level tables)
    coords_p: torch.Tensor  # (d, *lat, P), this rank's block under spmd
    pvalid: torch.Tensor | None = None  # (P_local,) 0 at padded dummy patches

    @property
    def ps(self):
        return self.struct.ps

    @property
    def spmd(self):
        return self.struct.spmd

    @property
    def dim(self):
        return self.ps.dim

    @property
    def tab(self):
        return self.data.tabs[self.ps.k]

    @property
    def free(self):
        return self.tab.free.to(self.coords_p.dtype)  # (*lat, P); bcasts

    @functools.cached_property
    def geo(self):
        """The mesh's cell geometry (pdfm.cell_geometry), derived once: a
        bundle's coordinates and mask stay as they were made."""
        return pdfm.cell_geometry(self.ps, self.coords_p, self.pvalid)

    def _psum(self, v):
        return v if self.spmd is None else self.spmd.all_reduce(v)

    def _pmax(self, v):
        return v if self.spmd is None else self.spmd.all_reduce(v, "max")

    def _norm(self, v):
        """A norm from this rank's partial norm v: the root of the summed
        squares."""
        return v if self.spmd is None else torch.sqrt(self._psum(v * v))

    @property
    def _P_local(self):
        return self.coords_p.shape[-1]

    def zeros_field(self, dtype):
        lvl = self.ps.fine
        return self.coords_p.new_zeros((self.dim,) + lvl.lat_shape + (self._P_local,), dtype=dtype)

    def zeros_tensor(self, dtype):
        d = self.dim
        T = len(self.ps.class_offsets)
        m = self.ps.fine.m
        return self.coords_p.new_zeros((d, d, T) + (m,) * d + (self._P_local,), dtype=dtype)

    def _apply(self, W, x):
        return pst.exchange_sum(None, pst.apply_w(self.ps, W, x), self.tab, spmd=self.spmd) * self.free

    def A(self, x):
        return self._apply(self.data.W[self.ps.k], x)

    def M(self, r):
        return pmg.vcycle_p(self.struct, self.data, r)

    def dot(self, x, y):
        return pst.owner_dot(None, x, y, self.tab, spmd=self.spmd)

    def dot_batch(self, Xs, Ys):
        """Owner-weighted (i, j) Gram block in one pass: the Schur assembly
        needs m*(1+m) pairings, one matmul instead of 20 separate dots."""
        w = self.tab.owner.to(Xs.dtype)
        Xf = (Xs * w).reshape(Xs.shape[0], -1)
        Yf = Ys.reshape(Ys.shape[0], -1)
        return self._psum(Xf @ Yf.T)

    def _cons(self, x_add):
        """additive -> consistent + free mask (any leading axes)."""
        return pst.exchange_sum(None, x_add, self.tab, spmd=self.spmd) * self.free

    def constraints(self, u, ref_volume, ref_barycenter):
        g = pdfm.constraints_p(self.ps, self.geo, u, 0.0, self.coords_p.new_zeros(self.dim))
        refs = torch.cat([
            torch.as_tensor(ref_volume, dtype=g.dtype, device=g.device).reshape(1),
            torch.as_tensor(ref_barycenter, dtype=g.dtype, device=g.device),
        ])
        # references subtracted after the reduction: a rank's values are partial sums
        return self._psum(g) - refs

    def constraint_grads(self, u, ref_volume, ref_barycenter):
        return self._cons(pdfm.constraint_grads_analytic_p(self.ps, self.geo, u, ref_volume, ref_barycenter))

    def constraint_hvp(self, u, Lmbda, ref_volume, ref_barycenter, x):
        return self._cons(pdfm.constraint_hvp_analytic_p(
            self.ps, self.geo, u, Lmbda, ref_volume, ref_barycenter, x * self.free,
        ))

    def hvp_fn(self, u, Lmbda, ref_volume, ref_barycenter):
        state = pdfm.hvp_state_p(self.ps, self.geo, u, Lmbda)

        def apply(x):
            return self._cons(pdfm.constraint_hvp_apply_p(self.ps, self.geo, state, x * self.free))

        return apply

    def hess_fn(self, u, Lmbda, ref_volume, ref_barycenter):
        """x -> (A + sum_k Lambda_k g_k'') x with the constraint Hessian
        assembled into the stencil once per Newton iterate
        (stencil_kernels.assemble_hess: one kernel launch for a 3D field on
        the card, assemble_w over pdfm.hvp_corner_block_fn otherwise, in
        A's storage): every Krylov matvec is then one stencil apply +
        exchange, for one field or all lanes.  The apply's ``path`` says
        which form assembled it, "kernel" or "plain".  Padded dummy patches
        (pvalid 0) add no Hessian."""
        W_H = sk.assemble_hess(self.ps, self.data.W[self.ps.k], self.coords_p, u, Lmbda,
                               self.tab.free.to(u.dtype), self.pvalid)

        def apply(x):
            return self._apply(W_H, x)

        apply.path = sk.hess_path(self.ps, u)
        return apply

    def tensor_rhs(self, M):
        return self._cons(pdfm.tensor_rhs_p(self.ps, self.geo, M))

    def grad_tensor(self, u):
        return pdfm.cell_grads(self.ps, self.geo, u)

    def z_update(self, u, lam, tau, sigma, norm_name):
        return pdfm.z_update_p(self.ps, self.geo, u, lam, tau, sigma, norm_name)

    def dual_update(self, u, lam, q_proj, tau):
        return pdfm.dual_update_p(self.ps, self.geo, u, lam, q_proj, tau)

    def max_grad_norm(self, u, norm_name):
        if norm_name == "spectral":
            return self._pmax(pdfm.max_spectral_norm_p(self.ps, self.geo, u, self.pvalid))
        return self._pmax(pdfm.max_frobenius_norm_p(self.ps, self.geo, u, self.pvalid))

    def norm_p1(self, f):
        return self._norm(pdfm.l2_norm_p1_p(self.ps, self.geo, f))

    def norm_pc(self, T):
        return self._norm(pdfm.l2_norm_pc_p(self.ps, self.geo, T))
