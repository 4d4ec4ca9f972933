"""The deformation multigrid solve end to end: the port's counterpart of
bench.py's ``get_mesh`` + ``assemble_ctx`` + ``run_size``.

    ctx = build(4)                          # on the card, float32: host mesh, tables, assembly
    b = random_rhs(ctx, seed=0)             # free-masked right-hand side
    res = solve(ctx, b)                     # cg_ir_p to a 1e-8 true residual

    ctx = prepare(hier, c_grad=2.0)         # the same without the assembly, any hierarchy
    data = assemble(ctx, X)                 # multigrid data on the mesh X (V, d)
    ctx = prepare(hier, backend="global")   # block-ELL levels (solvers.mg): any mesh

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
from typing import Callable

import numpy as np
import torch

from . import resolve_device
from .core import geomgen
from .core.mesh import Hierarchy, refine
from .core.patches import PatchSet, build_patchset
from .ops import patchstencil as st
from .ops import sparsity
from .ops.deformation import deformation_corner_block_fn, deformation_elem_mats
from .ops.p1space import P1VectorSpace
from .ops.deformation import vertex_plan as dfm_vertex_plan
from .solvers import mg, patch_mg

DIRICHLET = ("inlet", "wall", "outlet")
# bench.py run_size: cg_ir_p(rel_tol=1e-8, max_rounds=8, inner_rel=1e-5,
# inner_iters=80)
SOLVE_SETTINGS = dict(rel_tol=1e-8, max_rounds=8, inner_rel=1e-5, inner_iters=80)
# bench.py's V-cycle: Chebyshev V(2,2) with cheb_lower = 0.2
BENCH_SMOOTHING = dict(pre_smooth=2, post_smooth=2, cheb_lower=0.2)


@dataclasses.dataclass
class SolveContext:
    hier: Hierarchy
    ps: PatchSet | None  # None on the global backend
    struct: patch_mg.PatchMGStructure | mg.MGStructure
    tabs: list | None  # per level: st.LevelTables
    corner_fn: Callable  # the block protocol of the element matrices
    base_dense_fn: Callable  # (V0, d) level-0 coordinates -> dense base inverse
    data: patch_mg.PatchMGData | None  # assembled at coords by build; None after prepare
    coords: torch.Tensor  # (V, d) fine-mesh coordinates on the device
    host_seconds: float  # mesh hierarchy + patchset + level tables
    assembly_seconds: float  # assemble_patch_mg, synchronized
    # the global backend: the deformation space, its operator coefficients
    # (c_eps, c_grad, c_mass) and the fixed-order vertex sum of its fine
    # elements (ops.deformation.vertex_plan)
    space: P1VectorSpace | None = None
    coeffs: tuple = ()
    vplan: object = None

    @property
    def n_dofs(self) -> int:
        return self.hier.fine.num_vertices * self.hier.dim


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def prepare(hier: Hierarchy, device=None, dtype=torch.float32, c_eps: float = 1.0, c_grad: float = 1.0,
            c_mass: float = 1.0, smoothing: dict = BENCH_SMOOTHING, backend: str = "patch",
            ps: PatchSet | None = None) -> SolveContext:
    """Everything of the solve that does not depend on the mesh's
    coordinates: the patchset of hier, its level tables, the V-cycle
    structure (PatchMGStructure with the arguments in smoothing, bench.py's
    by default), the level-0 wiring of the dense base solve, and the
    operator c_eps eps(u):eps(w) + c_grad grad(u):grad(w) + c_mass u.w.
    data stays None: assemble() makes it at any coordinates.
    backend "global": the P1VectorSpace of hier with its block-ELL
    patterns and the solvers.mg structure (smoothing's arguments, the
    space's V(3,3) Chebyshev cycle when empty), on any mesh.  ps: the
    patchset of hier when it was built already (build_patchset(hier), in
    another process perhaps); None builds it here."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    if backend == "global":
        space = P1VectorSpace.build(hier, dirichlet=DIRICHLET)
        coords = torch.as_tensor(hier.fine.coords, dtype=dtype, device=device)
        vplan = dfm_vertex_plan(hier.fine.elems, hier.fine.num_vertices)
        _sync(device)
        return SolveContext(hier, None, space.mg_structure(**smoothing), None, None, None, None, coords,
                            time.perf_counter() - t0, 0.0, space=space, coeffs=(c_eps, c_grad, c_mass), vplan=vplan)
    if ps is None:
        ps = build_patchset(hier)
    tabs = patch_mg.make_level_tables(ps, dtype, device)
    coords = torch.as_tensor(hier.fine.coords, dtype=dtype, device=device)
    struct = patch_mg.PatchMGStructure(ps, **smoothing)
    _sync(device)
    return SolveContext(
        hier, ps, struct, tabs, deformation_corner_block_fn(c_eps, c_grad, c_mass),
        base_solver(hier.levels[0], device, c_eps, c_grad, c_mass), None, coords, time.perf_counter() - t0, 0.0,
    )


def base_solver(lvl0, device, c_eps: float = 1.0, c_grad: float = 1.0, c_mass: float = 1.0) -> Callable:
    """The level-0-only wiring of the dense base solve on the coarse mesh
    lvl0: level-0 coordinates (V0, d) -> the dense inverse of the operator
    with its Dirichlet rows and columns baked (a rank of a sharded solve
    makes its own from the coarse mesh it is handed)."""
    pat0 = sparsity.build_pattern(lvl0.elems, lvl0.num_vertices, lvl0.dim)
    fixed0 = torch.as_tensor(np.repeat(lvl0.vertex_mask(DIRICHLET)[None], lvl0.dim, axis=0), device=device)
    elems0 = torch.as_tensor(lvl0.elems.astype(np.int64), device=device)

    def base_dense_fn(coords0):
        em0 = deformation_elem_mats(coords0, elems0, c_eps, c_grad, c_mass)
        v0 = sparsity.assemble_values(pat0, em0)
        v0 = sparsity.bake_dirichlet(pat0, v0, fixed0)
        # outside any kernel, as the JAX package leaves it to XLA
        return torch.linalg.inv(sparsity.to_dense(pat0, v0))

    return base_dense_fn


def assemble_deformation_p(ps: PatchSet, struct: patch_mg.PatchMGStructure, lvl0, coords_p, tabs: list,
                           cfg=None) -> patch_mg.PatchMGData:
    """The deformation operator as symmetric half stencils on every level
    and its dense base inverse, from the fine lattice coordinates coords_p
    (d, *lat, P) of the whole patch set or of a rank's block (struct.spmd
    set).  cfg: an optim.admm.ADMMConfig whose (c_eps, tau, c_mass) weigh
    the operator; None: all 1, bench.py's operator."""
    coeffs = (1.0, 1.0, 1.0) if cfg is None else (cfg.c_eps, cfg.tau, cfg.c_mass)
    return patch_mg.assemble_patch_mg_p(ps, struct, coords_p, deformation_corner_block_fn(*coeffs),
                                        base_solver(lvl0, coords_p.device, *coeffs), tabs, sym=True)


def assemble(ctx: SolveContext, X: torch.Tensor):
    """The multigrid data of ctx's operator on the mesh X (V, d): symmetric
    half stencils on every level and a dense base inverse (PatchMGData),
    or on the global backend the block-ELL levels (mg.MGData)."""
    if ctx.space is not None:
        return ctx.space.assemble_mg(ctx.struct, X, *ctx.coeffs)
    return patch_mg.assemble_patch_mg(
        ctx.ps, ctx.struct, X.contiguous(), ctx.corner_fn, ctx.base_dense_fn, tabs=ctx.tabs, sym=True,
    )


def build(num_refs: int, device=None, dtype=torch.float32) -> SolveContext:
    """Host hierarchy + patchset of the 3D geomgen channel, level-0 wiring
    of the dense base solve, and the device assembly of every level, at
    bench.py's settings.  device defaults to the card (an error without
    one); "cpu" takes the plain forms."""
    t0 = time.perf_counter()
    levels = [geomgen.channel_3d()]
    for _ in range(num_refs):
        levels.append(refine(levels[-1]))
    ctx = prepare(Hierarchy(levels), device, dtype)
    ctx.host_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx.data = assemble(ctx, ctx.coords)
    _sync(ctx.coords.device)
    ctx.assembly_seconds = time.perf_counter() - t0
    return ctx


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
