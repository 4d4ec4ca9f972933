"""P1 vector function space over a refinement hierarchy and its GMG wiring
(port of admm_optim_tpu/ops/p1space.py), the global backend's deformation
space and the NS velocity block's P1-iso-P2 space.

Coarse-level coordinates are the prefix slice of the fine coordinates
(core.mesh invariant), so every level re-assembles from the current
geometry.  The JAX package jits one kernel per level; here each level is
plain eager torch on the device of the coordinates given.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.mesh import Hierarchy
from ..solvers.mg import MGData, MGStructure, Transfer, estimate_lmax
from . import sparsity
from .convdiff import convdiff_elem_mats
from .deformation import deformation_elem_mats


@dataclasses.dataclass
class P1VectorSpace:
    """Static wiring of a (block-)P1 space over all hierarchy levels.

    ncomp: dofs per vertex - the mesh dimension for the vector deformation
    and velocity spaces, 1 for scalar spaces."""

    hier: Hierarchy
    dirichlet: tuple
    patterns: tuple
    fixed: list  # per level (C, V) bool numpy
    parents: list  # per level l >= 1: Transfer into level l-1
    elems: list  # per level (E, d+1) int numpy
    nv: list  # vertices per level
    ncomp: int = 0
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, hier: Hierarchy, dirichlet=("inlet", "wall", "outlet"), ncomp=None) -> "P1VectorSpace":
        C = hier.dim if ncomp is None else ncomp
        patterns, fixed, elems, nv = [], [], [], []
        for lvl in hier.levels:
            patterns.append(sparsity.build_pattern(lvl.elems, lvl.num_vertices, C))
            fixed.append(np.repeat(lvl.vertex_mask(dirichlet)[None, :], C, axis=0))  # (C, V)
            elems.append(np.asarray(lvl.elems))
            nv.append(lvl.num_vertices)
        parents = [Transfer(np.asarray(hier.levels[l].parents), nv[l - 1]) for l in range(1, len(hier.levels))]
        return cls(hier, tuple(dirichlet), tuple(patterns), fixed, parents, elems, nv, ncomp=C)

    @property
    def fine_pattern(self) -> sparsity.Pattern:
        return self.patterns[-1]

    def level_tensors(self, l: int, device):
        """(elems int64, fixed bool) of level l on device (cached)."""
        key = (l, torch.device(device))
        if key not in self._dev:
            self._dev[key] = (torch.as_tensor(self.elems[l].astype(np.int64), device=device),
                              torch.as_tensor(self.fixed[l], device=device))
        return self._dev[key]

    def free_mask(self, level: int = -1, dtype=torch.float64, device="cpu"):
        """(C, V) float mask: 1 at free dofs, 0 at Dirichlet dofs."""
        return torch.as_tensor(~self.fixed[level], dtype=dtype, device=device)

    def mg_structure(self, pre_smooth=3, post_smooth=3, cheb_lower=0.25) -> MGStructure:
        return MGStructure(patterns=self.patterns, n_levels=len(self.patterns), pre_smooth=pre_smooth,
                           post_smooth=post_smooth, cheb_lower=cheb_lower)

    def _level(self, l, em, tmap=None):
        pat = self.patterns[l]
        _, fixed = self.level_tensors(l, em.device)
        vals = sparsity.bake_dirichlet(pat, sparsity.assemble_values(pat, em), fixed)
        diag = sparsity.diag_cn(pat, vals).reshape(-1)
        free = (~fixed).to(vals.dtype).reshape(-1)
        vals_t = sparsity.transpose_values(pat, vals, tmap) if tmap is not None else None
        return vals, diag, free, estimate_lmax(pat, vals, diag), vals_t

    def _data(self, levels, with_transpose=False):
        vals_l, diag_l, free_l, lmax_l, vt_l = (list(v) for v in zip(*levels))
        base_inv = torch.linalg.inv(sparsity.to_dense(self.patterns[0], vals_l[0]))
        return MGData(vals_l, diag_l, free_l, list(self.parents), lmax_l, base_inv,
                      vals_t=vt_l if with_transpose else None)

    def assemble_mg(self, struct: MGStructure, fine_coords, c_eps: float, c_grad: float, c_mass: float) -> MGData:
        """The constant SPD extension operator on every level from the
        current fine-grid coordinates (V, d)."""
        assert self.ncomp in (0, self.hier.dim), (
            "assemble_mg builds the vector elasticity operator; scalar spaces use assemble_mg_convdiff")
        levels = []
        for l in range(len(self.patterns)):
            elems, _ = self.level_tensors(l, fine_coords.device)
            em = deformation_elem_mats(fine_coords[: self.nv[l]], elems, c_eps, c_grad, c_mass)
            levels.append(self._level(l, em))
        return self._data(levels)

    def transpose_maps(self):
        if "tmaps" not in self._dev:
            self._dev["tmaps"] = [sparsity.transpose_map(p) for p in self.patterns]
        return self._dev["tmaps"]

    def assemble_mg_convdiff(self, struct: MGStructure, fine_coords, w_fine, visc: float,
                             with_transpose: bool = False) -> MGData:
        """Per-level convection-diffusion operators nu*grad:grad + (w.grad u,
        v) with the frozen advecting velocity w (d, V_fine) injected onto
        each level by prefix slicing.  with_transpose stores each level's
        exact in-pattern transposed values (the V-cycle's gather-based
        transpose)."""
        tmaps = self.transpose_maps() if with_transpose else [None] * len(self.patterns)
        levels = []
        for l in range(len(self.patterns)):
            elems, _ = self.level_tensors(l, fine_coords.device)
            em = convdiff_elem_mats(fine_coords[: self.nv[l]], elems, w_fine[:, : self.nv[l]], visc,
                                    ncomp=self.ncomp or None)
            levels.append(self._level(l, em, tmaps[l]))
        return self._data(levels, with_transpose)
