"""The Navier-Stokes path end to end: the forward Newton solve, the
cold-start viscosity ladder, the drag, the adjoint and the shape gradient,
wired as the JAX package's models/obstacle.py wires them: on the patch
backend (its ``use_patch_ns``: assembled lattice Jacobian, block-triangular
preconditioner with one Jacobi V(2,2) conv-diff cycle for the velocity on
the once-refined lattice, stepped FGMRES with GCRO-DR), on the global
backend (its ``use_ell_jac``: the per-element assembled Jacobian of
ops.ns_elljac, the velocity cycle of solvers.mg on the once-refined P1
space with its transposed values, the same Krylov loops).

    ctx = build(2, visc=0.02, backend="global")   # any mesh; 2D: "alt" diagonals

    ctx = build(2, visc=0.16)     # on the card, float32: host mesh, tables
    out = run(ctx)                # cold start, Newton, drag, adjoint, J'
    out.newton.iters, out.adjoint.iters, out.drag, out.jprime_norm

    ctx = build(2, visc=0.02, pressure_precond="pcd")
    lad = solve_ladder(ctx)       # 0.16 -> 0.08 -> 0.04 -> 0.02, recycling
    out = run(ctx, target_visc=0.02)   # ladder, then drag, adjoint, J' at 0.02

    build(2, ns_assembled_jac="off")          # matrix-free jvp / vjp
    build(2, vorder=1, stab=0.05)             # P1/P1, Brezzi-Pitkaranta

The mesh is the 3D geomgen channel (or the 2D one with dim=2) refined
``num_refs`` times; the velocity V-cycle runs on the once more refined
P1-iso-P2 lattice (vorder=1: on the NS level's own).  refs=2 is
3d_admm.lua's default size: 383,400 NS unknowns, fine velocity lattice
9^3 x 224, pressure lattice 5^3 x 224.  float32 runs take ``f32_presets``.

The pressure block of the preconditioner is ``pressure_precond``: "mass"
(lumped mass / nu, the Stokes surrogate) or "pcd" (the Kay-Loghin-Wathen
pressure convection-diffusion Schur approximation Mp^-1 Fp Ap^-1, whose
scalar stencils run through the full-stencil kernel at C = 1 on the patch
backend, and through the ELL forms on the global one).  The Jacobian is
assembled (``ns_assembled_jac`` "on", or "auto" while its bytes stay under
``ns_jac_mem_cap``; never with vorder=1) or matrix-free: then the Newton
matvec is the jvp of the residual, the adjoint's J^T one vjp per solve, and
the preconditioner's B^T the residual's affine pressure term
(ns_solver._bt_coupling).  ``run`` without a target solves at ``ctx.visc``
from the cold start, the first rung of the JAX package's continuation when
visc is 0.16; with a target it runs the whole cold-start ladder first.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device
from .core import geomgen
from .core.mesh import Hierarchy, refine
from .core.patches import PatchSet, build_patchset
from .ops import navier_stokes as nsops
from .ops import ns_elljac as elljac
from .ops import ns_patchjac as nsjac
from .ops import patchstencil as st
from .ops import sparsity
from .ops import stencil_kernels as sk
from .ops.convdiff import convdiff_elem_mats
from .ops.p1space import P1VectorSpace
from .solvers import ns_solver, patch_mg
from .solvers.ns_solver import NewtonConfig
from .utils.profiling import span

NS_DIR = ("inlet", "wall", "obstacle_surface")  # velocity Dirichlet with the do-nothing outlet
DEF_DIR = ("inlet", "wall", "outlet")  # deformation Dirichlet: masks J'
PCD_DIR = ("inlet",)  # Dirichlet rows of the PCD Ap and Fp: where the flow enters


def f32_presets(cfg: NewtonConfig) -> NewtonConfig:
    """The NS part of models.obstacle.f32_presets: tolerances a float32 run
    can reach."""
    from .models.obstacle import ProblemConfig, f32_presets as presets

    return presets(ProblemConfig(ns=cfg)).ns


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
    base0: dict  # level-0 wiring of the dense base solves (patterns, masks, elems)
    parents_fine: torch.Tensor  # (V_fine, 2) midpoint parents of the refined level
    coords: torch.Tensor  # (V, d)
    obstacle_vmask: torch.Tensor  # (V,)
    free_def: torch.Tensor  # (d, V) deformation free mask
    visc: float  # the target viscosity (the JAX package's cfg.visc)
    stab: float
    cfg: NewtonConfig
    host_seconds: float
    pressure_precond: str = "mass"
    vel_inner: int = 1
    # pressure_precond == "pcd": scalar tables with the inlet-Dirichlet free
    # masks and the Jacobi V(2,2) structure on the level-k patchset
    pcd_tabs: list | None = None
    pcd_struct: patch_mg.PatchMGStructure | None = None
    # backend "global": the P1 space over levels 0..L+1 of the velocity
    # cycle (pre_struct is then its mg.MGStructure) and the per-element
    # Jacobian wiring; the lattice fields above are None
    backend: str = "patch"
    pre_space: P1VectorSpace | None = None
    ell: elljac.EllJacWiring | None = None
    # PCD on the global backend: the scalar inlet-Dirichlet P1 pressure
    # space (pcd_struct is then its mg.MGStructure)
    p_space: P1VectorSpace | None = None
    # False: no assembled Jacobian (vorder=1, ns_assembled_jac "off", or
    # above ns_jac_mem_cap under "auto"): jvp / vjp and _bt_coupling
    assembled: bool = True
    jac_bytes: int = 0  # what the assembled Jacobian needs (0 with vorder=1)
    # newton replays each iterate's Jacobian and preconditioner applies
    # from CUDA graphs (ns_solver._Graphed) on the card; taken only on the
    # patch backend with the assembled Jacobian and the mass block
    graphs: bool = True

    @property
    def graphed(self) -> bool:
        """Whether newton's linear solves replay CUDA graphs."""
        return self.graphs and self.backend == "patch" and self.assembled and self.pressure_precond == "mass"

    @property
    def n_state(self) -> int:
        return self.space.n_state

    def at_visc(self, visc: float) -> "NSContext":
        """This context with another target viscosity (tables shared)."""
        return self if float(visc) == self.visc else dataclasses.replace(self, visc=float(visc))

    def base_dense_fn(self, arg):
        """Dense inverse of the level-0 conv-diff operator of the velocity
        V-cycle from the (V0, 2d) stacked [coords | velocity].  As in the JAX
        package it is assembled at the target viscosity ctx.visc on every
        rung of the ladder; the lattice levels above it take the rung's."""
        b, dim = self.base0, self.space.dim
        em = convdiff_elem_mats(arg[:, :dim], b["elems"], arg[:, dim:].T, self.visc)
        v0 = sparsity.bake_dirichlet(b["pat_v"], sparsity.assemble_values(b["pat_v"], em), b["fixed_v"])
        return _inv(sparsity.to_dense(b["pat_v"], v0))

    def ap_base_dense_fn(self, arg):
        """Dense inverse of the level-0 unit-viscosity pressure Laplacian
        (scalar pattern, inlet-Dirichlet) of the PCD Ap V-cycle."""
        b, dim = self.base0, self.space.dim
        em = convdiff_elem_mats(arg[:, :dim], b["elems"], arg[:, dim:].T, 1.0, ncomp=1)
        v0 = sparsity.bake_dirichlet(b["pat_p"], sparsity.assemble_values(b["pat_p"], em), b["fixed_p"])
        return _inv(sparsity.to_dense(b["pat_p"], v0))

    def jac(self, X, s, nu):
        if self.backend == "global":
            return elljac.assemble_ns_jacobian(self.space, self.ell, X, s, nu, self.stab)
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

    def pre_full(self, X, s, nu, seconds: dict | None = None):
        """Per-iterate data of the preconditioner and the Newton matvec,
        assembled at the viscosity nu of the current rung (obstacle.py
        _pre_full): (pre_data, pdiag, X, W) with the mass block,
        (pre_data, ap_data, W_fp, mp, X, W) with PCD on the patch backend,
        (pre_data, ap_data, fp_vals, mp, fp_vals_t, X, W) on the global
        one; W is the assembled Jacobian, or without one the B^T closure
        of ns_solver._bt_coupling.  seconds, when given, receives the
        synchronized assembly time of each part under "velocity", "pcd"
        and "jacobian" (or "coupling").  Each part is an ns.assemble span
        (attribute part), its two synchronizations host.sync spans."""
        def timed(name, fn):
            with span("ns.assemble", part=name):
                if seconds is None:
                    return fn()
                with span("host.sync"):
                    _sync(X.device)
                t0 = time.perf_counter()
                out = fn()
                with span("host.sync"):
                    _sync(X.device)
                seconds[name] = time.perf_counter() - t0
                return out

        p2_iso = self.space.vorder == 2
        if self.backend == "global":
            # the transposed values too: the adjoint's transposed cycle
            # stays a gather (obstacle.py _vel_pre, with_transpose=True)
            pre_data, pdiag = timed("velocity", lambda: ns_solver.ns_gmg_precond_data(
                self.space, self.pre_space, self.pre_struct, X, nu, s, with_transpose=True, p2_iso=p2_iso))
        else:
            pre_data, pdiag = timed("velocity", lambda: ns_solver.ns_gmg_precond_data_patch(
                self.space, self.pre_ps, self.pre_struct, self.pre_tabs, self.base_dense_fn,
                self.parents_fine, X, nu, s=s, p2_iso=p2_iso,
            ))
        mid = (pdiag,)
        if self.pressure_precond == "pcd" and self.backend == "global":
            mid = timed("pcd", lambda: ns_solver.ns_pcd_precond_data(
                self.space, self.p_space, self.pcd_struct, X, nu, s=s, with_transpose=True))
        elif self.pressure_precond == "pcd":
            mid = timed("pcd", lambda: ns_solver.ns_pcd_precond_data_patch(
                self.space, self.ps, self.pcd_struct, self.pcd_tabs, self.ap_base_dense_fn, X, nu, s=s,
            ))
        if self.assembled:
            W = timed("jacobian", lambda: self.jac(X, s, nu))
        else:
            # the coupling is viscosity-free: the JAX package builds it at cfg.visc
            W = timed("coupling", lambda: ns_solver._bt_coupling(self.space, X, self.visc, self.stab, X)[0])
        return (pre_data,) + tuple(mid) + (X, W)

    def M_fn(self, r, pre_data, *rest):
        """The block-triangular preconditioner with the assembled B^T (the
        viscosity-free coupling, exact on every rung), or the residual's
        without an assembled Jacobian: ns_gmg_M with the mass block,
        ns_pcd_M with PCD."""
        W = rest[-1]
        if self.assembled:
            bt = _bt(self)
            bt_fn = lambda zp: bt(zp, W)  # noqa: E731
        else:
            bt_fn = W
        if self.backend == "global":
            vel_M = ns_solver.ell_velocity_M(self.pre_struct, pre_data)
        else:
            vel_M = ns_solver.patch_velocity_M(self.pre_ps, self.pre_struct, pre_data, iters=self.vel_inner)
        if self.pressure_precond == "pcd" and self.backend == "global":
            schur = ns_solver.pcd_schur_ell_M(self.p_space, self.pcd_struct, *rest[:4])
        elif self.pressure_precond == "pcd":
            ap_data, W_fp, mp = rest[:3]
            schur = ns_solver.pcd_schur_patch_M(
                self.space, self.ps, self.pcd_struct, self.pcd_tabs, ap_data, W_fp, mp,
            )
        else:
            return ns_solver.ns_gmg_M(self.space, rest[0], vel_M, bt_fn=bt_fn)(r)
        return ns_solver.ns_pcd_M(self.space, schur, vel_M, bt_fn=bt_fn)(r)


def _matvecs(ctx):
    """(jv, jtv) of the assembled Jacobian; newton and adjoint take the
    matrix-free forms (jvp, ns_solver.residual_vjp) where ctx.assembled is
    False."""
    if ctx.backend == "global":
        return elljac.make_matvec_fns(ctx.space, ctx.ell)
    return nsjac.make_matvec_fns(ctx.space, ctx.ps, ctx.pre_ps, ctx.wiring, ctx.pre_tabs[-1], ctx.tab_c)


def _bt(ctx):
    if ctx.backend == "global":
        return elljac.make_bt_fn(ctx.space, ctx.ell)
    return nsjac.make_bt_fn(ctx.space, ctx.ps, ctx.pre_ps, ctx.wiring, ctx.pre_tabs[-1], ctx.tab_c)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _inv(A):
    """torch.linalg.inv without its error check, which reads the
    factorization's status back to the host once a call."""
    return torch.linalg.inv_ex(A)[0]


def channel(num_refs: int, dim: int = 3, diag: str = "fixed") -> Hierarchy:
    """The geomgen channel refined num_refs times: 3D, or 2D with fixed
    diagonals (the brick metadata of the patch backend) or with
    diag="alt", alternating ones (the JAX package's global-backend mesh,
    without brick metadata)."""
    levels = [geomgen.channel_3d() if dim == 3 else geomgen.channel_2d(diag=diag)]
    for _ in range(num_refs):
        levels.append(refine(levels[-1]))
    return Hierarchy(levels)


def build(num_refs: int | None = None, device=None, dtype=torch.float32, visc: float = 0.16, dim: int = 3,
          cfg: NewtonConfig | None = None, stab: float = 0.0, pressure_precond: str = "mass",
          vel_inner: int = 1, *, hier: Hierarchy | None = None, ps: PatchSet | None = None,
          tab_c: st.LevelTables | None = None, do_nothing: bool = True, diameter: float = 6.0,
          backend: str = "patch", vorder: int = 2, ns_assembled_jac: str = "auto",
          ns_jac_mem_cap: float = 6e9, graphs: bool = True) -> NSContext:
    """Host hierarchy, NS space, the level-k and once-refined patchsets
    with their device tables, and the level-0 wiring of the dense base
    solves.  device defaults to the card (an error without one); cfg
    defaults to NewtonConfig(), with f32_presets for float32.
    pressure_precond "pcd" adds the scalar pressure tables and V-cycle
    structure of the PCD Schur block; vel_inner > 1 runs that many
    V-cycle-preconditioned Richardson steps in the velocity block.
    hier replaces channel(num_refs, dim); ps and tab_c, the level-k
    patchset with the deformation's Dirichlet set and its fine tables,
    share the x-update's (models/obstacle.py:349-352, :398-405).
    do_nothing=False adds the outlet to the velocity's Dirichlet set.
    backend "global" takes the block-ELL pieces on any mesh (ps, tab_c and
    vel_inner are not used).  vorder 1 is P1/P1 velocity (with stab, the
    Brezzi-Pitkaranta term), whose velocity cycle runs on the NS levels
    themselves and which never assembles its Jacobian; ns_assembled_jac
    "on" / "off" / "auto" (assembled while the Jacobian's bytes stay under
    ns_jac_mem_cap) picks the assembled or the matrix-free operators
    (obstacle.py:357-416).  graphs=False runs newton's linear solves
    eagerly where they would replay CUDA graphs (NSContext.graphed)."""
    if pressure_precond not in ("mass", "pcd"):
        raise ValueError(f"pressure_precond must be 'mass' or 'pcd', got {pressure_precond!r}")
    if backend not in ("patch", "global"):
        raise ValueError(f"backend must be 'patch' or 'global', got {backend!r}")
    if ns_assembled_jac not in ("auto", "on", "off"):
        raise ValueError(f"ns_assembled_jac must be 'auto', 'on' or 'off', got {ns_assembled_jac!r}")
    device = resolve_device(device)
    t0 = time.perf_counter()
    if hier is None:
        hier = channel(num_refs, dim, diag="alt" if backend == "global" else "fixed")
    dim = hier.dim
    ns_dir = NS_DIR + (() if do_nothing else ("outlet",))
    lvl = hier.fine
    space = nsops.NSSpace.build(lvl, vorder=vorder, do_nothing=do_nothing, diameter=diameter)
    # the velocity cycle's hierarchy: P1-iso-P2 on the once-refined level,
    # or the NS levels themselves for P1 velocity (obstacle.py:235-238)
    fine_pre = refine(lvl) if vorder == 2 else None
    pre_hier = Hierarchy(hier.levels + [fine_pre]) if vorder == 2 else hier
    if cfg is None:
        cfg = f32_presets(NewtonConfig()) if dtype == torch.float32 else NewtonConfig()
    itemsize = torch.finfo(dtype).bits // 8
    common = dict(
        hier=hier, space=space,
        coords=torch.as_tensor(lvl.coords, dtype=dtype, device=device),
        obstacle_vmask=torch.as_tensor(lvl.subset_vertices["obstacle_surface"], dtype=dtype, device=device),
        free_def=torch.as_tensor(np.repeat(~lvl.vertex_mask(DEF_DIR)[None], dim, axis=0), dtype=dtype, device=device),
        visc=float(visc), stab=float(stab), cfg=cfg, host_seconds=0.0, pressure_precond=pressure_precond,
        vel_inner=int(vel_inner), graphs=bool(graphs),
    )

    def assembled(need):
        """The JAX package's use_ns_jac / use_ell_jac decision."""
        if vorder != 2 or ns_assembled_jac == "off":
            return False
        return ns_assembled_jac == "on" or need <= ns_jac_mem_cap

    if backend == "global":
        pre_space = P1VectorSpace.build(pre_hier, dirichlet=ns_dir)
        # jacobi smoothing: the conv-diff operator is nonsymmetric
        pre_struct = dataclasses.replace(pre_space.mg_structure(pre_smooth=2, post_smooth=2), smoother="jacobi")
        ell = elljac.build_wiring(space) if vorder == 2 else None
        need = elljac.jac_memory_bytes(ell, itemsize) if ell is not None else 0
        on = assembled(need)
        if on:
            ell.tables(device)  # the segment sums, on the host once
        p_space = pcd_struct = None
        if pressure_precond == "pcd":
            p_space, pcd_struct = ns_solver.ns_pcd_spaces(hier, do_nothing)
        ctx = NSContext(ps=None, pre_ps=None, pre_struct=pre_struct, pre_tabs=None, tab_c=None, wiring=None,
                        base0=None, parents_fine=None, backend="global", pre_space=pre_space,
                        ell=ell if on else None, p_space=p_space, pcd_struct=pcd_struct, assembled=on,
                        jac_bytes=need, **common)
        _sync(device)
        ctx.host_seconds = time.perf_counter() - t0
        return ctx
    pre_ps = build_patchset(pre_hier, dirichlet=ns_dir)
    pre_struct = patch_mg.PatchMGStructure(
        pre_ps, pre_smooth=2, post_smooth=2, smoother="jacobi", smoother_w="f32"
    )
    pre_tabs = patch_mg.make_level_tables(pre_ps, dtype, device)
    if ps is None:
        ps = build_patchset(hier)
        tab_c = st.make_tables(ps.fine, dtype, device)
    wiring = nsjac.build_wiring(ps) if vorder == 2 else None
    need = nsjac.jac_memory_bytes(ps, wiring, itemsize) if wiring is not None else 0
    lvl0 = hier.levels[0]
    base0 = dict(
        elems=torch.as_tensor(lvl0.elems.astype(np.int64), device=device),
        pat_v=sparsity.build_pattern(lvl0.elems, lvl0.num_vertices, dim),
        fixed_v=torch.as_tensor(np.repeat(lvl0.vertex_mask(ns_dir)[None], dim, axis=0), device=device),
    )
    pcd_tabs = pcd_struct = None
    if pressure_precond == "pcd":
        pcd_tabs = ns_solver.pcd_patch_tables(hier, ps, dtype, device)
        pcd_struct = patch_mg.PatchMGStructure(
            ps, pre_smooth=2, post_smooth=2, smoother="jacobi", smoother_w="f32"
        )
        base0.update(
            pat_p=sparsity.build_pattern(lvl0.elems, lvl0.num_vertices, 1),
            fixed_p=torch.as_tensor(lvl0.vertex_mask(PCD_DIR)[None], device=device),
        )
    ctx = NSContext(
        ps=ps, pre_ps=pre_ps, pre_struct=pre_struct, pre_tabs=pre_tabs,
        tab_c=tab_c, wiring=wiring, base0=base0,
        parents_fine=None if fine_pre is None else torch.as_tensor(fine_pre.parents.astype(np.int64), device=device),
        pcd_tabs=pcd_tabs, pcd_struct=pcd_struct, assembled=assembled(need), jac_bytes=need, **common,
    )
    _sync(device)
    ctx.host_seconds = time.perf_counter() - t0
    return ctx


def initial_state(ctx: NSContext, X=None):
    """Inlet data on the velocity, zero elsewhere and in the pressure
    (obstacle.py initial_state), on the mesh X (default ctx.coords)."""
    X = ctx.coords if X is None else X
    g = nsops.inlet_values(ctx.space, X)
    return ctx.space.pack(g, X.new_zeros((ctx.space.n_pressure,)))


def newton(ctx: NSContext, s0=None, visc: float | None = None, recycle: dict | None = None, X=None):
    """The forward Newton solve on the mesh X (default ctx.coords; (V, d),
    contiguous) at visc (default ctx.visc) from s0 (default: the cold
    start).  recycle carries the GCRO-DR space across calls
    (newton_solve_stepped).  Returns (NewtonResult, assembly seconds: per
    Newton iterate a dict {"velocity", "pcd" with PCD, "jacobian"}).  The
    linear solves replay CUDA graphs where ctx.graphed.  The call is one
    ns.newton span, with the attributes visc, iters and lin_iters (the
    linear iterations summed)."""
    X = ctx.coords if X is None else X
    nu = ctx.visc if visc is None else float(visc)
    assembly = []

    def pre_fn(s):
        assembly.append({})
        return ctx.pre_full(X, s, nu, seconds=assembly[-1])

    with span("ns.newton", visc=nu) as rec:
        s0 = initial_state(ctx, X) if s0 is None else s0
        res = ns_solver.newton_solve_stepped(
            ctx.space, X, s0, nu, ctx.stab, ctx.cfg, M_fn=ctx.M_fn, jv_fn=ctx.jv if ctx.assembled else None,
            pre_fn=pre_fn, recycle=recycle, graphs=ctx.graphed,
        )
        if rec is not None:
            rec["attrs"].update(iters=res.iters, lin_iters=sum(res.lin_iters))
    return res, assembly


class Rung(NamedTuple):
    nu: float
    inserted: bool  # a geometric-mean rung put in after a failed one
    newton: ns_solver.NewtonResult  # converged False: the rung failed and was retried
    assembly_seconds: list  # per Newton iterate {"velocity", "pcd", "jacobian": seconds}
    seconds: float  # wall time of the rung, synchronized


class LadderResult(NamedTuple):
    s: torch.Tensor  # the state at the target viscosity
    rungs: list  # one Rung per attempt, failed ones included, in order
    recycle: dict  # the GCRO-DR space the last rung left, under "U"


class LadderError(RuntimeError):
    """The ladder's last attempt did not converge; rungs holds the record
    of every attempt."""

    def __init__(self, message: str, rungs: list):
        super().__init__(message)
        self.rungs = rungs


def solve_ladder(ctx: NSContext, visc: float | None = None, start: float = 0.16) -> LadderResult:
    """The cold-start viscosity continuation of the optimization loop
    (obstacle.py run): Newton on every rung of continuation_ladder(visc)
    from the state of the rung before, the first from initial_state, with
    one GCRO-DR recycle dict for all rungs.  A rung that does not converge
    is retried from the last converged state at the geometric mean of its
    viscosity and the last converged one (at most 6 insertions); if the last
    attempt fails the ladder raises LadderError.  visc defaults to ctx.visc."""
    ctx = ctx if visc is None else ctx.at_visc(visc)
    dev = ctx.coords.device
    nus = continuation_ladder(ctx.visc, start)
    planned = set(nus)
    s = initial_state(ctx)
    recycle, rungs = {}, []
    nu_ok, bisects, i = None, 0, 0
    while i < len(nus):
        nu = nus[i]
        _sync(dev)
        t0 = time.perf_counter()
        res, assembly = newton(ctx, s, visc=nu, recycle=recycle)
        _sync(dev)
        rungs.append(Rung(nu, nu not in planned, res, assembly, time.perf_counter() - t0))
        if res.converged:
            s, nu_ok = res.s, nu
            i += 1
            continue
        if bisects >= 6:
            break
        prev = nu_ok if nu_ok is not None else nus[0] * 2.0
        nus.insert(i, float(np.sqrt(prev * nu)))
        bisects += 1
    if not res.converged:
        raise LadderError(f"initial NS solve failed: residual {res.res_norm}", rungs)
    return LadderResult(s, rungs, recycle)


def adjoint(ctx: NSContext, s, X=None, lam0=None, recycle: dict | None = None):
    """The adjoint on the mesh X (default ctx.coords) at the state s and at
    ctx.visc with the exact transpose of the forward preconditioner built
    at s (obstacle.py _adjoint_stepped); lam0 and recycle are its warm
    start (ns_solver.adjoint_solve_stepped).  Without an assembled
    Jacobian J^T is ns_solver.residual_vjp at s."""
    X = ctx.coords if X is None else X
    m_args = ctx.pre_full(X, s, ctx.visc)
    W = m_args[-1]
    MT = ns_solver.transpose_M(lambda r: ctx.M_fn(r, *m_args), ctx.n_state, X.dtype, X.device)
    if ctx.assembled:
        Jt = lambda v: ctx.jtv(v, W)  # noqa: E731
    else:
        Jt = ns_solver.residual_vjp(ctx.space, X, s, ctx.visc, ctx.stab)
    return ns_solver.adjoint_solve_stepped(
        ctx.space, X, s, ctx.visc, Jt, MT, ctx.cfg, lam0=lam0, recycle=recycle, stab=ctx.stab,
    )


def jprime(ctx: NSContext, s, lam, X=None):
    """The shape gradient (d, V) on the mesh X (default ctx.coords): masked
    to the obstacle surface and by the deformation's free mask (obstacle.py
    _jprime)."""
    X = ctx.coords if X is None else X
    g = ns_solver.shape_gradient(ctx.space, X, s, lam, ctx.visc, ctx.stab, ctx.obstacle_vmask)
    return (g.T * ctx.free_def).contiguous()


class NSRun(NamedTuple):
    newton: ns_solver.NewtonResult  # at the target viscosity (the last rung of a ladder)
    assembly_seconds: list  # of that solve: per Newton iterate, seconds per part
    drag: float
    adjoint: ns_solver.AdjointResult
    jprime: torch.Tensor  # (d, V)
    jprime_norm: float
    seconds: dict  # per phase, synchronized
    launches: dict  # per phase: kernel launch counts (reset before each phase)
    launches_by_lattice: dict  # per phase: the same by (kernel, lattice)
    rungs: list | None = None  # the ladder's Rung records when a target was given


def run(ctx: NSContext, target_visc: float | None = None, adjoint_iters: int | None = None,
        s0=None) -> NSRun:
    """Without a target: cold start, Newton at ctx.visc, drag, adjoint, J'.
    With one: the cold-start ladder down to target_visc (solve_ladder), or
    from the state s0 one rung, Newton at target_visc with no recycle space,
    then drag, adjoint and J' at the target.  adjoint_iters cuts the
    adjoint's budget (4 * lin_max_iters) to about that many iterations.
    The kernel launch counts are reset before each phase and read after
    it."""
    if target_visc is not None:
        ctx = ctx.at_visc(target_visc)
    actx = ctx if adjoint_iters is None else dataclasses.replace(
        ctx, cfg=dataclasses.replace(ctx.cfg, lin_max_iters=adjoint_iters // 4))
    dev = ctx.coords.device
    seconds, launches, by_lattice = {}, {}, {}

    def phase(name, fn):
        sk.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        seconds[name] = time.perf_counter() - t0
        launches[name] = dict(sk.launches)
        by_lattice[name] = dict(sk.launches_by_lattice)
        return out

    rungs = None
    if target_visc is None:
        nres, assembly = phase("newton", lambda: newton(ctx))
    elif s0 is None:
        rungs = phase("newton", lambda: solve_ladder(ctx)).rungs
        nres, assembly = rungs[-1].newton, rungs[-1].assembly_seconds
    else:
        nres, assembly = phase("newton", lambda: newton(ctx, s0, recycle={}))
        rungs = [Rung(ctx.visc, False, nres, assembly, seconds["newton"])]
    drag = phase("drag", lambda: float(nsops.drag(ctx.space, ctx.coords, nres.s, ctx.visc)))
    ares = phase("adjoint", lambda: adjoint(actx, nres.s))
    jp = phase("jprime", lambda: jprime(ctx, nres.s, ares.lam))
    return NSRun(nres, assembly, drag, ares, jp, float(torch.linalg.vector_norm(jp)), seconds, launches, by_lattice, rungs)
