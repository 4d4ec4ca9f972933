"""The patch-backend Navier-Stokes path end to end: the forward Newton
solve, the drag, the adjoint and the shape gradient, wired as the JAX
package's models/obstacle.py wires them for ``use_patch_ns`` (assembled
lattice Jacobian, block-triangular preconditioner with one Jacobi V(2,2)
conv-diff cycle for the velocity, stepped FGMRES with GCRO-DR).

    ctx = build(2, "cuda", torch.float32, visc=0.16)   # host mesh, tables
    out = run(ctx)        # cold start, Newton, drag, adjoint, J'
    out.newton.iters, out.adjoint.iters, out.drag, out.jprime_norm

The mesh is the 3D geomgen channel (or the 2D one with dim=2) refined
``num_refs`` times; the velocity V-cycle runs on the once more refined
P1-iso-P2 lattice.  refs=2 is 3d_admm.lua's default size: 383,400 NS
unknowns, fine velocity lattice 9^3 x 224.  float32 runs take
``f32_presets``.  The ladder of viscosities to the target is the
optimization driver's and is not run here: ``run`` solves at ``ctx.visc``
from the cold start, the first rung of the JAX package's continuation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .core import geomgen
from .core.mesh import Hierarchy, refine
from .core.patches import PatchSet, build_patchset
from .ops import navier_stokes as nsops
from .ops import ns_patchjac as nsjac
from .ops import patchstencil as st
from .ops import sparsity
from .ops import stencil_kernels as sk
from .ops.convdiff import convdiff_elem_mats
from .solvers import ns_solver, patch_mg
from .solvers.ns_solver import NewtonConfig

NS_DIR = ("inlet", "wall", "obstacle_surface")  # velocity Dirichlet, do-nothing outlet
DEF_DIR = ("inlet", "wall", "outlet")  # deformation Dirichlet: masks J'


def f32_presets(cfg: NewtonConfig) -> NewtonConfig:
    """The NS part of the JAX package's f32_presets (obstacle.py:153-162):
    tolerances a float32 run can reach."""
    return dataclasses.replace(
        cfg,
        accept_tol=max(cfg.accept_tol, 1e-4),
        abs_tol=max(cfg.abs_tol, 1e-6),
        lin_rel_tol=max(cfg.lin_rel_tol, 1e-4),
        lin_abs_tol=max(cfg.lin_abs_tol, 1e-6),
        adj_rel_tol=max(cfg.adj_rel_tol, 1e-6),
    )


def continuation_ladder(visc: float, start: float = 0.16):
    """Geometric viscosity ladder start -> visc (obstacle.py:166-174)."""
    nus = []
    nu = start
    while nu > visc * 1.0001:
        nus.append(nu)
        nu *= 0.5
    nus.append(visc)
    return nus


@dataclasses.dataclass
class NSContext:
    hier: Hierarchy
    space: nsops.NSSpace
    ps: PatchSet  # level-k lattice (pressure, Jacobian cells)
    pre_ps: PatchSet  # once-refined lattice (velocity V-cycle)
    pre_struct: patch_mg.PatchMGStructure
    pre_tabs: list
    tab_c: st.LevelTables
    wiring: nsjac.NSJacWiring
    base_dense_fn: object
    parents_fine: torch.Tensor  # (V_fine, 2) midpoint parents of the refined level
    coords: torch.Tensor  # (V, d)
    obstacle_vmask: torch.Tensor  # (V,)
    free_def: torch.Tensor  # (d, V) deformation free mask
    visc: float
    stab: float
    cfg: NewtonConfig
    host_seconds: float

    @property
    def n_state(self) -> int:
        return self.space.n_state

    def jac(self, X, s, nu):
        v0, p0 = self.space.unpack(s)
        return nsjac.assemble_ns_jacobian(
            self.space, self.ps, self.wiring, st.to_patch_tab(self.tab_c, X.T),
            st.to_patch_tab(self.pre_tabs[-1], v0), st.to_patch_tab(self.tab_c, p0[None]),
            nu, self.stab,
        )

    def jv(self, x, W):
        return _matvecs(self)[0](x, W)

    def jtv(self, x, W):
        return _matvecs(self)[1](x, W)

    def pre_full(self, X, s, nu):
        """Per-iterate data of the preconditioner and the Newton matvec:
        (pre_data, pdiag, X, W), W the assembled Jacobian (obstacle.py
        _pre_full)."""
        pre_data, pdiag = ns_solver.ns_gmg_precond_data_patch(
            self.space, self.pre_ps, self.pre_struct, self.pre_tabs, self.base_dense_fn,
            self.parents_fine, X, nu, s=s,
        )
        return pre_data, pdiag, X, self.jac(X, s, nu)

    def M_fn(self, r, pre_data, pdiag, X, W):
        """The block-triangular preconditioner with the assembled B^T."""
        bt = _bt(self)
        return ns_solver.ns_gmg_M(
            self.space, pdiag, ns_solver.patch_velocity_M(self.pre_ps, self.pre_struct, pre_data),
            bt_fn=lambda zp: bt(zp, W),
        )(r)


def _matvecs(ctx):
    return nsjac.make_matvec_fns(ctx.space, ctx.ps, ctx.pre_ps, ctx.wiring, ctx.pre_tabs[-1], ctx.tab_c)


def _bt(ctx):
    return nsjac.make_bt_fn(ctx.space, ctx.ps, ctx.pre_ps, ctx.wiring, ctx.pre_tabs[-1], ctx.tab_c)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(num_refs: int, device, dtype=torch.float32, visc: float = 0.16, dim: int = 3,
          cfg: NewtonConfig | None = None, stab: float = 0.0) -> NSContext:
    """Host hierarchy, NS space, the level-k and once-refined patchsets
    with their device tables, and the level-0 dense base solve of the
    velocity V-cycle.  cfg defaults to NewtonConfig(), with f32_presets
    for float32."""
    device = torch.device(device)
    t0 = time.perf_counter()
    base = geomgen.channel_3d() if dim == 3 else geomgen.channel_2d(diag="fixed")
    levels = [base]
    for _ in range(num_refs):
        levels.append(refine(levels[-1]))
    hier = Hierarchy(levels)
    lvl = hier.fine
    space = nsops.NSSpace.build(lvl, vorder=2)
    fine_pre = refine(lvl)
    pre_ps = build_patchset(Hierarchy(hier.levels + [fine_pre]), dirichlet=NS_DIR)
    pre_struct = patch_mg.PatchMGStructure(
        pre_ps, pre_smooth=2, post_smooth=2, smoother="jacobi", smoother_w="f32"
    )
    pre_tabs = patch_mg.make_level_tables(pre_ps, dtype, device)
    ps = build_patchset(hier)
    tab_c = st.make_tables(ps.fine, dtype, device)
    lvl0 = hier.levels[0]
    pat0 = sparsity.build_pattern(lvl0.elems, lvl0.num_vertices, dim)
    fixed0 = torch.as_tensor(np.repeat(lvl0.vertex_mask(NS_DIR)[None], dim, axis=0), device=device)
    elems0 = torch.as_tensor(lvl0.elems.astype(np.int64), device=device)

    def base_dense_fn(arg):  # (V0, 2d) stacked [coords | velocity]
        em = convdiff_elem_mats(arg[:, :dim], elems0, arg[:, dim:].T, visc)
        v0 = sparsity.bake_dirichlet(pat0, sparsity.assemble_values(pat0, em), fixed0)
        return torch.linalg.inv(sparsity.to_dense(pat0, v0))

    if cfg is None:
        cfg = f32_presets(NewtonConfig()) if dtype == torch.float32 else NewtonConfig()
    ctx = NSContext(
        hier=hier, space=space, ps=ps, pre_ps=pre_ps, pre_struct=pre_struct, pre_tabs=pre_tabs,
        tab_c=tab_c, wiring=nsjac.build_wiring(ps), base_dense_fn=base_dense_fn,
        parents_fine=torch.as_tensor(fine_pre.parents.astype(np.int64), device=device),
        coords=torch.as_tensor(lvl.coords, dtype=dtype, device=device),
        obstacle_vmask=torch.as_tensor(lvl.subset_vertices["obstacle_surface"], dtype=dtype, device=device),
        free_def=torch.as_tensor(np.repeat(~lvl.vertex_mask(DEF_DIR)[None], dim, axis=0), dtype=dtype, device=device),
        visc=float(visc), stab=float(stab), cfg=cfg, host_seconds=0.0,
    )
    _sync(device)
    ctx.host_seconds = time.perf_counter() - t0
    return ctx


def initial_state(ctx: NSContext):
    """Inlet data on the velocity, zero elsewhere and in the pressure
    (obstacle.py initial_state)."""
    g = nsops.inlet_values(ctx.space, ctx.coords)
    return ctx.space.pack(g, ctx.coords.new_zeros((ctx.space.n_pressure,)))


def newton(ctx: NSContext, s0=None):
    """The forward Newton solve at ctx.visc from s0 (default: the cold
    start).  Returns (NewtonResult, per-iterate assembly seconds)."""
    X = ctx.coords
    s0 = initial_state(ctx) if s0 is None else s0
    assembly = []

    def pre_fn(s):
        t0 = time.perf_counter()
        out = ctx.pre_full(X, s, ctx.visc)
        _sync(X.device)
        assembly.append(time.perf_counter() - t0)
        return out

    res = ns_solver.newton_solve_stepped(
        ctx.space, X, s0, ctx.visc, ctx.stab, ctx.cfg, M_fn=ctx.M_fn, jv_fn=ctx.jv, pre_fn=pre_fn,
    )
    return res, assembly


def adjoint(ctx: NSContext, s):
    """The adjoint at the state s with the exact transpose of the forward
    preconditioner built at s (obstacle.py _adjoint_stepped)."""
    X = ctx.coords
    m_args = ctx.pre_full(X, s, ctx.visc)
    W = m_args[-1]
    MT = ns_solver.transpose_M(lambda r: ctx.M_fn(r, *m_args), ctx.n_state, X.dtype, X.device)
    return ns_solver.adjoint_solve_stepped(
        ctx.space, X, s, ctx.visc, lambda v: ctx.jtv(v, W), MT, ctx.cfg,
    )


def jprime(ctx: NSContext, s, lam):
    """The shape gradient (d, V): masked to the obstacle surface and by the
    deformation's free mask (obstacle.py _jprime)."""
    X = ctx.coords
    g = ns_solver.shape_gradient(ctx.space, X, s, lam, ctx.visc, ctx.stab, ctx.obstacle_vmask)
    return g.T * ctx.free_def


class NSRun(NamedTuple):
    newton: ns_solver.NewtonResult
    assembly_seconds: list  # preconditioner + Jacobian assembly per Newton iterate
    drag: float
    adjoint: ns_solver.AdjointResult
    jprime: torch.Tensor  # (d, V)
    jprime_norm: float
    seconds: dict  # per phase, synchronized
    launches: dict  # per phase: kernel launch counts (reset before each phase)


def run(ctx: NSContext) -> NSRun:
    """Cold start, Newton at ctx.visc, drag, adjoint, J'.  The kernel
    launch counts are reset before each phase and read after it."""
    dev = ctx.coords.device
    seconds, launches = {}, {}

    def phase(name, fn):
        sk.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        seconds[name] = time.perf_counter() - t0
        launches[name] = dict(sk.launches)
        return out

    nres, assembly = phase("newton", lambda: newton(ctx))
    drag = phase("drag", lambda: float(nsops.drag(ctx.space, ctx.coords, nres.s, ctx.visc)))
    ares = phase("adjoint", lambda: adjoint(ctx, nres.s))
    jp = phase("jprime", lambda: jprime(ctx, nres.s, ares.lam))
    return NSRun(nres, assembly, drag, ares, jp, float(torch.linalg.vector_norm(jp)), seconds, launches)
