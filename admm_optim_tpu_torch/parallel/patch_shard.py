"""The brick-patch multigrid and the ADMM inner loop sharded over ranks
(port of admm_optim_tpu/parallel/patch_shard.py).

The patch lattice (core.patches) is sharded along the patch axis P over
the space axis of a parallel.sharding.Mesh: rank s of a batch row holds the
contiguous block [s * Pl, (s + 1) * Pl) of every field, of every sharded
level's tables and of the stencils it assembles.  Patches are coarse
bricks on every level, so one partition serves the whole V-cycle.  Levels
below ``replicate_below`` are held whole on every rank (the reference's
process-hierarchy agglomeration, 2d_admm.lua:174-206), and the level-0
base solve is a dense solve every rank makes from the all-reduced
residual (the gatheredBaseSolverIfAmbiguous analogue,
obstacle_optim_util.lua:21).

The single-device code runs unchanged on a rank's block with
``PatchMGStructure.spmd`` set: per operator application one all-reduce of
the duplicate sites whose groups span ranks (ops.patchstencil
exchange_sum), per dot one all-reduce of a scalar.  Where the JAX package
runs one shard_map region, each rank here runs the host loops of
solvers.patch_mg and optim.admm, taking every loop decision on all-reduced
values.  P is padded to a multiple of the ranks with inert patches
(core.patches.pad_patchset); ``pvalid`` masks them out of the ADMM's
volume, barycenter and Hessian terms.

``shard_field`` and ``gather_field`` carry full padded (..., P) arrays,
such as numpy arrays of the JAX package, to a rank's block and back.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ..core.patches import PatchSet, pad_patchset
from ..ops import patchstencil as st
from ..optim import admm as admm_mod
from ..optim.spaces import PatchOps
from ..solvers import patch_mg as pmg
from ..xupdate_solve import assemble_deformation_p
from .sharding import Mesh


@dataclasses.dataclass
class ShardedPatchMG:
    """One rank's view of a sharded patch hierarchy and its entry points."""

    ps: PatchSet  # the padded patch set (P % n_space == 0)
    struct: pmg.PatchMGStructure  # carries the SpmdCtx
    mesh: Mesh
    P_orig: int  # patches before padding: the pvalid boundary
    data_dtype: torch.dtype = torch.float32

    @property
    def spmd(self) -> st.SpmdCtx:
        return self.struct.spmd

    @property
    def n_shards(self) -> int:
        return self.spmd.nshards

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ---- placement --------------------------------------------------------

    def make_tables(self, dtype=None) -> list:
        """Per level the rank's tables (whole below replicate_below)."""
        return pmg.make_level_tables(
            self.ps, self.data_dtype if dtype is None else dtype, self.device, self.spmd,
            self.struct.replicate_below,
        )

    def shard_field(self, x, dtype=None):
        """A full padded (..., P) array (numpy or torch) -> this rank's
        contiguous (..., Pl) block on the mesh's device."""
        if x.shape[-1] != self.ps.P:
            raise ValueError(f"the last axis holds {x.shape[-1]} patches, the padded set {self.ps.P}")
        Pl = self.ps.P // self.n_shards
        blk = slice(self.spmd.offset(Pl), self.spmd.offset(Pl) + Pl)
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x[..., blk])
        else:
            x = x[..., blk]
        return torch.as_tensor(x, dtype=dtype, device=self.device).contiguous()

    def gather_field(self, x):
        """This rank's (..., Pl) block -> the full (..., P) array on every
        rank of the space group."""
        return self.spmd.all_gather_p(x.contiguous())

    def pad_field(self, x_patch, dtype=None):
        """An unpadded (..., P_orig) patch array -> zeros on the padding,
        then this rank's block."""
        x = torch.as_tensor(x_patch)
        pad = self.ps.P - x.shape[-1]
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
        return self.shard_field(x, dtype)

    def to_patch_sharded(self, v_global, dtype=None):
        """A global (C, V) vector (numpy or torch) -> this rank's block of
        its patch layout; padded patches copy patch 0's values, as they copy
        its vertex ids."""
        v = torch.as_tensor(v_global, dtype=dtype, device=self.device)
        return self.spmd.take_block(st.to_patch(self.ps.fine, v))

    def pvalid(self, dtype=None):
        """(Pl,) patch validity of this rank's block: 1 on real patches, 0
        on the padding."""
        v = (np.arange(self.ps.P) < self.P_orig).astype(np.float64)
        return self.shard_field(v, self.data_dtype if dtype is None else dtype)

    # ---- the solver on the rank's block -----------------------------------

    def assemble(self, coords_p, lvl0, cfg=None, tabs: list | None = None) -> pmg.PatchMGData:
        """The rank's multigrid data of the deformation operator
        (xupdate_solve.assemble_deformation_p; cfg's coefficients, None: all
        1) from its block of the fine lattice coordinates (d, *lat, Pl);
        lvl0 is the coarse mesh of the base solve, tabs the rank's tables
        (None: made here)."""
        tabs = self.make_tables() if tabs is None else tabs
        return assemble_deformation_p(self.ps, self.struct, lvl0, coords_p, tabs, cfg)

    def vcycle(self, data, b):
        return pmg.vcycle_p(self.struct, data, b)

    def solve(self, data, b, max_iters: int = 60, rel_tol: float = 1e-8, abs_tol: float = 0.0):
        """MG-preconditioned CG (solvers.patch_mg.cg_p) on the rank's block."""
        return pmg.cg_p(self.struct, data, b, max_iters=max_iters, rel_tol=rel_tol, abs_tol=abs_tol)

    def solve_ir(self, data, b, rel_tol: float = 1e-8, abs_tol: float = 0.0, max_rounds: int = 8,
                 inner_rel: float = 1e-4, inner_iters: int = 40) -> pmg.IRResult:
        """The double-float refinement solve (solvers.patch_mg.cg_ir_p); its
        defect exchange sums each group's zero-masked values, which is
        error-free."""
        return pmg.cg_ir_p(self.struct, data, b, rel_tol=rel_tol, abs_tol=abs_tol, max_rounds=max_rounds,
                           inner_rel=inner_rel, inner_iters=inner_iters)

    # ---- the ADMM inner loop ----------------------------------------------

    def admm_inner(self, cfg: admm_mod.ADMMConfig, data, coords_p, pvalid, Jp, sigma: float, scaling: float,
                   ref_vol, ref_bary, **hooks) -> admm_mod.ADMMState:
        """optim.admm.admm_inner on the rank's block: the z-prox, the
        constrained Newton x-updates with their MG-preconditioned Krylov
        solves, and the dual ascent (2d_admm.lua:868-1253).  hooks:
        admm_inner's."""
        ops_ = PatchOps(self.struct, data, coords_p, pvalid=pvalid)
        return admm_mod.admm_inner(cfg, ops_, Jp, sigma, scaling, ref_vol, ref_bary, **hooks)

    def admm_inner_batched(self, cfg: admm_mod.ADMMConfig, data, coords_p, pvalid, JpB, sigmas, scaling: float,
                           ref_vol, ref_bary) -> list:
        """A design sweep over the batch axis: of the B instances (JpB
        (B, C, *lat, Pl), sigmas (B,)), this rank's batch row runs its
        B / n_batch, one after the other, on the shared operators; returns
        their states.  (The JAX package vmaps them and freezes finished
        lanes; that freeze is not ported.)"""
        B = len(sigmas)
        if B % self.mesh.n_batch:
            raise ValueError(f"{B} instances do not split over {self.mesh.n_batch} batch rows")
        per = B // self.mesh.n_batch
        mine = range(self.mesh.batch_index * per, (self.mesh.batch_index + 1) * per)
        return [self.admm_inner(cfg, data, coords_p, pvalid, JpB[i], float(sigmas[i]), scaling, ref_vol, ref_bary)
                for i in mine]


def build_sharded_mg(
    ps: PatchSet,
    mesh: Mesh,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    cheb_lower: float = 0.25,
    replicate_below: int = 0,
    data_dtype=torch.float32,
) -> ShardedPatchMG:
    """Pad P to a multiple of the space axis and wire the sharded MG
    structure.  replicate_below: levels below it run agglomerated."""
    ps_pad = pad_patchset(ps, mesh.n_space)
    if not 0 <= replicate_below <= ps_pad.k:
        raise ValueError(f"replicate_below={replicate_below} out of range [0, {ps_pad.k}]")
    struct = pmg.PatchMGStructure(
        ps_pad, pre_smooth=pre_smooth, post_smooth=post_smooth, cheb_lower=cheb_lower,
        spmd=st.SpmdCtx(mesh.space_group, mesh.space_index, mesh.n_space), replicate_below=replicate_below,
    )
    return ShardedPatchMG(ps_pad, struct, mesh, ps.P, data_dtype)
