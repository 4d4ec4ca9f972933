"""The deformation multigrid solve end to end: the port's counterpart of
bench.py's ``get_mesh`` + ``assemble_ctx`` + ``run_size``.

    ctx = build(4, "cuda", torch.float32)   # host mesh, tables, assembly
    b = random_rhs(ctx, seed=0)             # free-masked right-hand side
    res = solve(ctx, b)                     # cg_ir_p to a 1e-8 true residual

The mesh is the 3D geomgen channel refined ``num_refs`` times (refs=4 is
bench.py's headline size: 947,970 vertices, 2,843,910 DoF, fine lattice
17^3 x 224 patches).  The operator is the deformation extension form with
c_eps = c_grad = c_mass = 1, assembled as symmetric half stencils, and the
preconditioner a Chebyshev V(2,2) cycle with cheb_lower = 0.2 - bench.py's
settings.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .core import geomgen
from .core.mesh import Hierarchy, refine
from .core.patches import PatchSet, build_patchset
from .ops import patchstencil as st
from .ops import sparsity
from .ops.deformation import deformation_corner_block_fn, deformation_elem_mats
from .solvers import patch_mg

DIRICHLET = ("inlet", "wall", "outlet")
# bench.py run_size: cg_ir_p(rel_tol=1e-8, max_rounds=8, inner_rel=1e-5,
# inner_iters=80)
SOLVE_SETTINGS = dict(rel_tol=1e-8, max_rounds=8, inner_rel=1e-5, inner_iters=80)


@dataclasses.dataclass
class SolveContext:
    hier: Hierarchy
    ps: PatchSet
    struct: patch_mg.PatchMGStructure
    data: patch_mg.PatchMGData
    coords: torch.Tensor  # (V, d) fine-mesh coordinates on the device
    host_seconds: float  # mesh hierarchy + patchset + level tables
    assembly_seconds: float  # assemble_patch_mg, synchronized

    @property
    def n_dofs(self) -> int:
        return self.hier.fine.num_vertices * self.hier.dim


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(num_refs: int, device, dtype=torch.float32) -> SolveContext:
    """Host hierarchy + patchset of the 3D geomgen channel, level-0 wiring
    of the dense base solve, and the device assembly of every level."""
    device = torch.device(device)
    t0 = time.perf_counter()
    levels = [geomgen.channel_3d()]
    for _ in range(num_refs):
        levels.append(refine(levels[-1]))
    hier = Hierarchy(levels)
    ps = build_patchset(hier)
    tabs = patch_mg.make_level_tables(ps, dtype, device)
    # level-0-only wiring of the base solve
    lvl0 = hier.levels[0]
    pat0 = sparsity.build_pattern(lvl0.elems, lvl0.num_vertices, hier.dim)
    fixed0 = torch.as_tensor(
        np.repeat(lvl0.vertex_mask(DIRICHLET)[None], hier.dim, axis=0), device=device
    )
    elems0 = torch.as_tensor(lvl0.elems.astype(np.int64), device=device)
    coords = torch.as_tensor(hier.fine.coords, dtype=dtype, device=device)
    _sync(device)
    host_seconds = time.perf_counter() - t0

    def base_dense_fn(coords0):
        em0 = deformation_elem_mats(coords0, elems0, 1.0, 1.0, 1.0)
        v0 = sparsity.assemble_values(pat0, em0)
        v0 = sparsity.bake_dirichlet(pat0, v0, fixed0)
        # outside any kernel, as the JAX package leaves it to XLA
        return torch.linalg.inv(sparsity.to_dense(pat0, v0))

    struct = patch_mg.PatchMGStructure(ps, pre_smooth=2, post_smooth=2, cheb_lower=0.2)
    t0 = time.perf_counter()
    data = patch_mg.assemble_patch_mg(
        ps, struct, coords, deformation_corner_block_fn(1.0, 1.0, 1.0),
        base_dense_fn, tabs=tabs, sym=True,
    )
    _sync(device)
    return SolveContext(
        hier, ps, struct, data, coords, host_seconds, time.perf_counter() - t0
    )


def random_rhs(ctx: SolveContext, seed: int = 0) -> torch.Tensor:
    """Normal right-hand side from default_rng(seed), zero on Dirichlet
    vertices, in patch layout (bench.py run_size)."""
    fine = ctx.hier.fine
    rng = np.random.default_rng(seed)
    b_g = rng.normal(size=(ctx.hier.dim, fine.num_vertices))
    b_g = b_g * (~fine.vertex_mask(DIRICHLET))[None]
    b_g = torch.as_tensor(b_g, dtype=ctx.coords.dtype, device=ctx.coords.device)
    return st.to_patch(ctx.ps.fine, b_g)


def solve(ctx: SolveContext, b: torch.Tensor) -> patch_mg.IRResult:
    """cg_ir_p with bench.py's settings."""
    return patch_mg.cg_ir_p(ctx.struct, ctx.data, b, **SOLVE_SETTINGS)
