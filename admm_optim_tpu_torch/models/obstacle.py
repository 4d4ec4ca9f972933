"""The optimization step: drag-minimizing obstacle shape optimization in
steady incompressible Navier-Stokes channel flow (port of
admm_optim_tpu/models/obstacle.py, the reference's 2d_admm.lua /
3d_admm.lua outer loop), on the patch and on the global backend.

    cfg = f32_presets(ProblemConfig(dim=3, num_refs=2, visc=0.02))
    prob = ObstacleShapeOpt(cfg)               # on the card, float32
    hist = prob.run(num_steps=1)               # ladder, then one step
    hist[0].drag, prob.step_log[0]["seconds"]

    ObstacleShapeOpt(cfg, device="cpu", dtype=torch.float64)   # the plain forms
    ObstacleShapeOpt(dataclasses.replace(cfg, backend="global"))   # block-ELL
    ObstacleShapeOpt(ProblemConfig(grid_path="box.ugx", num_refs=1))

The backend is the JAX package's selection: "patch" (brick-lattice
stencils, the hand-written kernels) when the mesh carries brick metadata
and backend is "auto" or "patch"; "global" otherwise (a .ugx grid, the 2D
channel with alternating diagonals, backend="global"): the x-update on
solvers.mg's block-ELL V-cycle (optim.spaces.GlobalOps), the NS side on
the per-element assembled Jacobian (ops.ns_elljac) and the ELL velocity
cycle.  The global backend launches no hand-written kernel.

Per step (obstacle.py:1248-1495): the adjoint (warm from the last step's
lambda and GCRO-DR space), the masked shape gradient J', then attempts
until one is accepted: the deformation multigrid assembled at X, the ADMM
inner loop, X_new = X + u, the tangle test, the NS re-solve at X_new
(warm, its recycle space carried across rungs and steps), and the descent
test.  A failed ADMM halves sigma in 2D and the J' scaling in 3D
(admm_failure_control "auto"); a tangled mesh, a diverged re-solve or no
descent halve sigma.

Around the loop (obstacle.py:1045-1498): the reference's telemetry files
and VTUs through io.telemetry and io.vtk, a checkpoint after the ladder
("step -1") and after every accepted step with the accepted history and
the failure catalogue, the warm sidecar <checkpoint>.warm.npz (the
adjoint's lambda and GCRO-DR space, the forward recycle space), the
profiler's phases, and the debug outputs (newton_output, debug_output,
debug_nodal_positions, debug_nans).

The port has only the host-stepped drivers, so the JAX package's
``num_elems > 20000`` switches between monolithic and stepped drivers are
gone.  The variants of obstacle.py:235-560 all run: ``b2nd_order`` (the
J'' term in the x-update, the Hessian of drag + lambda^T R in X applied by
double backward; it puts the x-update on the global backend, the NS side
keeping the patch one on a brick mesh), ``vorder=1`` (P1/P1 with the
``stab`` term, never an assembled Jacobian), the matrix-free NS jvp / vjp
(``ns_assembled_jac="off"``, or a Jacobian above ``ns_jac_mem_cap`` under
"auto"), and PCD on the global backend.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from .. import ns_run, resolve_device, xupdate_solve
from ..core.mesh import Hierarchy
from ..core.ugx import SubsetInfo, UgxGrid, write_ugx
from ..io.checkpoint import save_checkpoint
from ..io.vtk import write_vtu
from ..ops import navier_stokes as nsops
from ..ops import patchstencil as st
from ..ops import stencil_kernels as sk
from ..ops.deformation import barycenter
from ..ops.geometry import elem_geometry
from ..optim import admm
from ..optim.spaces import PatchOps
from ..solvers import ns_solver
from ..utils import debug
from ..utils.profiling import Profiler


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """All reference CLI knobs (2d_admm.lua:43-87) in one place: the JAX
    package's ProblemConfig, every field and default unchanged (see its
    comments for the measurements behind them)."""

    dim: int = 2
    num_refs: int = 3  # -numRefs
    num_steps: int = 400  # -numSteps
    visc: float = 0.02  # -visc
    stab: float = 0.0  # -stab
    sigma_threshold: float = 0.3  # -sigma_threshold
    scaling: float = 1.0  # -scaling
    line_search_param: float = 1e-5  # -line_search
    do_nothing: bool = True  # -bDoNothing
    vorder: int = 2  # velocity order (reference: constant vorder=2)
    b2nd_order: bool = False  # -b2ndOrder (2d:86): J'' term in the x-update
    high_order_scaling: float = 1.0  # -hscaling (2d:51)
    diameter: float = 6.0
    max_attempts_per_step: int = 12  # bound on the reference's while(true)
    grid_path: str | None = None  # load a .ugx instead of generating
    pressure_precond: str = "mass"  # NS pressure block: "mass" | "pcd"
    vel_inner: int = 1  # V-cycle-preconditioned Richardson steps of the velocity block
    backend: str = "auto"  # "patch" | "global" | "auto" (patch when the mesh has bricks)
    ns_assembled_jac: str = "auto"  # "auto" | "on" | "off"
    ns_jac_mem_cap: float = 6e9  # bytes of W above which "auto" refuses
    # step-size control on ADMM failure: "auto" halves sigma in 2D
    # (2d_admm.lua:1269) and the J' scaling in 3D (3d_admm.lua:1322)
    admm_failure_control: str = "auto"  # "auto" | "sigma" | "scaling"
    newton_output: bool = False  # -bNewtonOutput
    debug_output: bool = False  # -bDebugOutput
    debug_nodal_positions: bool = False  # -bDebugNodalPositions
    debug_nans: bool = False  # -debugNans
    admm: admm.ADMMConfig = dataclasses.field(default_factory=admm.ADMMConfig)
    ns: ns_solver.NewtonConfig = dataclasses.field(default_factory=ns_solver.NewtonConfig)


def f32_presets(cfg: ProblemConfig) -> ProblemConfig:
    """Solver tolerances reachable in float32 (obstacle.py:121-163).  The
    3D x-update stop thresholds sit above the measured float32 floors of
    the constraint sums (|g| ~4e-5, |DeltaLambda| ~7e-4 at refs=1): with
    tighter ones every ADMM call "fails" and the step-size control halves
    scaling to dust.  2D keeps the tighter values."""
    ns_tol_f, g_tol_f = (2e-3, 2e-4) if cfg.dim == 3 else (1e-4, 1e-5)
    a, n = cfg.admm, cfg.ns
    return dataclasses.replace(
        cfg,
        admm=dataclasses.replace(
            a, ns_tol=max(a.ns_tol, ns_tol_f),
            ns_abs_tol=max(a.ns_abs_tol, 1e-5),
            ns_abs_llambda_tol=max(a.ns_abs_llambda_tol, g_tol_f),
            lin_abs_tol=max(a.lin_abs_tol, 1e-7),
            lin_rel_tol=max(a.lin_rel_tol, 1e-7),
            # the float32 Krylov floor grows with the mesh: accept a
            # stagnated solve at <= 1e-4 relative
            lin_accept_rel=max(a.lin_accept_rel, 1e-4),
        ),
        ns=dataclasses.replace(
            n, accept_tol=max(n.accept_tol, 1e-4),
            abs_tol=max(n.abs_tol, 1e-6),
            lin_rel_tol=max(n.lin_rel_tol, 1e-4),
            lin_abs_tol=max(n.lin_abs_tol, 1e-6),
            adj_rel_tol=max(n.adj_rel_tol, 1e-6),
        ),
    )


@dataclasses.dataclass
class StepRecord:
    step: int
    drag: float
    drag_diff: float
    shape_derivative: float
    sigma: float
    scaling: float
    admm_iters: int
    newton_iters: int
    lin_iters: int
    attempts: int
    wall_time: float
    # per-solve-slot Krylov iteration sums (rhs, B_vol, B_x, B_y(, B_z)) -
    # the reference's sum_rhssolver/sum_b*solver counters (2d:1379-1381)
    solver_iters: tuple = ()


def _refuse(cfg: ProblemConfig):
    """ValueError for settings the JAX package refuses too."""
    if cfg.backend not in ("auto", "patch", "global"):
        raise ValueError(f"backend must be 'auto', 'patch' or 'global', got {cfg.backend!r}")
    if cfg.admm_failure_control not in ("auto", "sigma", "scaling"):
        raise ValueError(f"admm_failure_control must be 'auto', 'sigma' or 'scaling', got {cfg.admm_failure_control!r}")
    if cfg.ns_assembled_jac not in ("auto", "on", "off"):
        raise ValueError(f"ns_assembled_jac must be 'auto', 'on' or 'off', got {cfg.ns_assembled_jac!r}")
    if cfg.vorder not in (1, 2):
        raise ValueError(f"unsupported velocity order {cfg.vorder}")


def _host(t) -> np.ndarray:
    """A tensor as a host numpy array (what io/ writes)."""
    return t.detach().cpu().numpy()


def _tensors(obj):
    """The tensors of a nested dataclass / list / tuple (the assembled
    multigrid data), for the finite check."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


class _Phases:
    """Seconds and kernel launches per phase of one step, summed over its
    attempts.  The seconds are the profiler's: its phase synchronizes the
    device once, at the phase's end.  Launches are differences of the
    counters in ops.stencil_kernels, which are never reset here."""

    def __init__(self, device, prof: Profiler):
        self.device, self.prof = device, prof
        self.seconds, self.launches, self.by_lattice = {}, {}, {}

    def __call__(self, name, fn):
        before, before_lat = dict(sk.launches), dict(sk.launches_by_lattice)
        with self.prof.phase(name, sync=self.device):
            out = fn()
        self.seconds[name] = self.seconds.get(name, 0.0) + self.prof.last
        for counts, old, tot in ((sk.launches, before, self.launches.setdefault(name, {})),
                                 (sk.launches_by_lattice, before_lat, self.by_lattice.setdefault(name, {}))):
            for key, n in counts.items():
                if n != old.get(key, 0):
                    tot[key] = tot.get(key, 0) + n - old.get(key, 0)
        return out


class ObstacleShapeOpt:
    """End-to-end shape optimization on a channel/obstacle mesh: the geomgen
    channel, or a .ugx grid (cfg.grid_path), on the patch or the global
    backend (module docstring)."""

    def __init__(self, cfg: ProblemConfig, hier: Hierarchy | None = None, device=None,
                 dtype=torch.float32):
        _refuse(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        if hier is None:
            if cfg.grid_path is not None:
                hier = Hierarchy.from_ugx(cfg.grid_path, cfg.num_refs)
            else:
                # fixed 2D diagonals carry the patch backend's brick
                # metadata; the global backend's 2D channel alternates them
                hier = ns_run.channel(cfg.num_refs, cfg.dim, diag="alt" if cfg.backend == "global" else "fixed")
        if hier.dim != cfg.dim:
            raise ValueError(f"the mesh is {hier.dim}D, the configuration {cfg.dim}D")
        self.hier = hier
        # backend selection (obstacle.py:245-251, :301-305, :357-416): the
        # NS side is the patch one on a brick mesh (use_patch_ns); the
        # x-update too, unless b2nd_order, whose J'' term lives on global
        # fields and puts the x-update on the global backend
        bricks = cfg.backend in ("auto", "patch") and hier.levels[0].bricks is not None
        self.use_patch_ns = bricks
        self.use_patch = bricks and not cfg.b2nd_order
        if cfg.backend == "patch" and not self.use_patch:
            raise ValueError("backend='patch' needs brick metadata (a geomgen mesh) and b2nd_order=False")
        a = cfg.admm
        # the x-update: deformation operator with the loop's coefficients
        # (c_grad = tau) and the default V(3,3) Chebyshev cycle
        # (obstacle.py:318-340); assembled at X on every attempt
        self.xu = xupdate_solve.prepare(hier, self.device, dtype, a.c_eps, a.tau, a.c_mass, smoothing={},
                                        backend="patch" if self.use_patch else "global")
        # the NS side shares the level-k patchset and its fine tables with
        # a patch x-update (obstacle.py:349-352, :398-405); the Jacobian is
        # assembled or matrix-free by ns_assembled_jac, ns_jac_mem_cap and
        # vorder (ns_run.build)
        self.ns = ns_run.build(
            device=self.device, dtype=dtype, visc=cfg.visc, cfg=cfg.ns, stab=cfg.stab,
            pressure_precond=cfg.pressure_precond, vel_inner=cfg.vel_inner, hier=hier,
            ps=self.xu.ps if self.use_patch else None, tab_c=self.xu.tabs[-1] if self.use_patch else None,
            do_nothing=cfg.do_nothing, diameter=cfg.diameter, backend="patch" if self.use_patch_ns else "global",
            vorder=cfg.vorder, ns_assembled_jac=cfg.ns_assembled_jac, ns_jac_mem_cap=cfg.ns_jac_mem_cap,
        )
        fine = hier.fine
        self.X0 = self.ns.coords
        self.elems = torch.as_tensor(fine.elems.astype(np.int64), device=self.device)
        _, det0, _, vol = elem_geometry(self.X0, self.elems)
        self.ref_volume = vol.sum()
        self.ref_barycenter = barycenter(self.X0, self.elems, torch.zeros_like(self.X0.T))
        # element inversion is judged against the undeformed orientation
        # (brick/Kuhn meshes carry mixed signed orientations)
        self._sign0 = torch.sign(det0)
        self.obstacle_vmask = self.ns.obstacle_vmask
        # warm starts carried across steps: the adjoint's lambda and its
        # GCRO-DR space, the forward solves' recycle space (across the
        # ladder's rungs too)
        self._cur_lam_adj = self._cur_Jp = None
        self._cur_X = self._cur_s = None  # the step's mesh and state, for the CLI's callbacks
        self._adj_recycle = {}
        self._ns_recycle = {}
        self.ladder = None  # ns_run.LadderResult of the cold start
        self.step_log = []  # per step: seconds, launches and attempts (see run)
        self.sidecar_restored = {}  # what _load_warm_sidecar took: key -> shape

    def initial_state(self, X):
        return ns_run.initial_state(self.ns, X)

    def _min_det(self, X):
        return float(torch.min(self._sign0 * elem_geometry(X, self.elems)[1]))

    def _drag(self, X, s):
        return float(nsops.drag(self.ns.space, X, s, self.cfg.visc))

    def _admm(self, mgdata, X, Jp, sigma, scaling, iter_cb=None, newton_hist_out=None, full_stats_out=None,
              debug_out=None):
        """admm_inner at X (obstacle.py:931-1019): on the global
        representation directly; on the patch lattice with X and J' in
        patch layout, u and the debug fields back to global (d, V) by
        owner."""
        hooks = dict(newton_hist_out=newton_hist_out, full_stats_out=full_stats_out, debug_out=debug_out)
        if not self.use_patch:
            return admm.admm_inner_global(
                self.cfg.admm, self.xu.struct, mgdata, X, self.elems, self.ns.free_def, Jp, sigma, scaling,
                self.ref_volume, self.ref_barycenter, vplan=self.xu.vplan,
                iter_cb=None if iter_cb is None else (lambda k, u, _Lambda: iter_cb(k, u)),
                extra_hvp=self._extra_hvp(X) if self.cfg.b2nd_order else None, **hooks)
        ps = self.xu.ps

        def to_global(up):
            return st.from_patch(ps.fine, up, X.shape[0], mode="owner")

        ops_ = PatchOps(self.xu.struct, mgdata, st.to_patch(ps.fine, X.T))
        res = admm.admm_inner(
            self.cfg.admm, ops_, st.to_patch(ps.fine, Jp), sigma, scaling, self.ref_volume,
            self.ref_barycenter,
            iter_cb=None if iter_cb is None else (lambda k, up, _Lambda: iter_cb(k, to_global(up))),
            **hooks,
        )
        if debug_out:
            for k in ("Lu", "rhs_large", "du"):
                debug_out[k] = to_global(debug_out[k])
        return dataclasses.replace(res, u=to_global(res.u))

    def _extra_hvp(self, X):
        """The J'' term of b2nd_order at X (obstacle.py:911-929): x (d, V)
        -> high_order_scaling times the directional derivative along x of
        the masked shape gradient at the step's frozen state and adjoint."""
        ns, free = self.ns, self.ns.free_def
        hvp = ns_solver.shape_hvp(ns.space, X, self._cur_s, self._cur_lam_adj, self.cfg.visc, self.cfg.stab,
                                  self.obstacle_vmask)

        def extra(x):
            return self.cfg.high_order_scaling * (hvp(x.T.contiguous()).T * free)

        return extra

    def _write_mesh_ugx(self, path: str, X) -> None:
        """Per-step mesh dump at the current (deformed) coordinates: the
        -bDebugOutput SaveGridLevelToFile parity (reference 2d:788)."""
        lvl = self.hier.fine
        coords = np.zeros((lvl.num_vertices, 3))
        coords[:, : lvl.dim] = _host(X)
        empty = np.zeros((0,), np.int32)
        subsets = {
            name: SubsetInfo(name=name, vertices=np.nonzero(mask)[0].astype(np.int32), edges=empty, faces=empty,
                             volumes=empty)
            for name, mask in lvl.subset_vertices.items()
        }
        write_ugx(path, UgxGrid(
            name="defGrid", coords=coords, edges=np.asarray(lvl.edges),
            triangles=lvl.elems if lvl.dim == 2 else np.zeros((0, 3), np.int32),
            tetrahedrons=lvl.elems if lvl.dim == 3 else np.zeros((0, 4), np.int32),
            subsets=subsets,
        ))

    # ---- warm-state sidecar (obstacle.py:1081-1124) ------------------------
    # Without it a resumed run starts the adjoint cold (zeros, no recycle
    # space) and re-pays the first solve's Krylov cost.  Kept apart from
    # the checkpoint: it only speeds the next step up.  The keys and the
    # (k, n_state) orientation of U are the JAX package's, so a sidecar
    # written by either package loads in the other.
    def _save_warm_sidecar(self, checkpoint_path: str) -> None:
        try:
            arrs = {}
            if self._cur_lam_adj is not None:
                arrs["lam_adj"] = _host(self._cur_lam_adj)
            for key, U in (("adj_U", self._adj_recycle.get("U")), ("ns_U", self._ns_recycle.get("U"))):
                if U is not None:
                    arrs[key] = _host(U)
            if not arrs:
                return
            tmp = checkpoint_path + ".warm.tmp.npz"
            np.savez(tmp, **arrs)
            os.replace(tmp, checkpoint_path + ".warm.npz")
        except Exception as e:  # noqa: BLE001 - never fail a step on this
            print(f"warm sidecar save failed ({e!r})", flush=True)

    def _load_warm_sidecar(self, checkpoint_path: str) -> None:
        path = checkpoint_path + ".warm.npz"
        if not os.path.exists(path):
            return
        try:
            with np.load(path) as z:
                n = int(self.ns.n_state)

                def dev(key):
                    self.sidecar_restored[key] = z[key].shape
                    return torch.as_tensor(z[key], dtype=self.dtype, device=self.device).contiguous()

                if "lam_adj" in z and z["lam_adj"].shape == (n,):
                    self._cur_lam_adj = dev("lam_adj")
                if "adj_U" in z and z["adj_U"].shape[-1:] == (n,):
                    self._adj_recycle["U"] = dev("adj_U")
                if "ns_U" in z and z["ns_U"].shape[-1:] == (n,):
                    self._ns_recycle["U"] = dev("ns_U")
            print(f"warm sidecar restored ({', '.join(sorted(z.files))})", flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"warm sidecar load failed ({e!r})", flush=True)

    def _ladder(self, verbose):
        """The cold-start viscosity continuation (obstacle.py:1174-1214)."""
        ns_run._sync(self.device)
        t0 = time.perf_counter()
        self.ladder = ns_run.solve_ladder(self.ns)
        ns_run._sync(self.device)
        self._ns_recycle = self.ladder.recycle
        if verbose:
            for r in self.ladder.rungs:
                print(f"continuation: nu={r.nu:.4f} newton={r.newton.iters} |R|={r.newton.res_norm:.2e} "
                      f"converged={r.newton.converged}")
            print(f"continuation: {time.perf_counter() - t0:.1f} s", flush=True)
        return self.ladder.s

    def _checkpoint(self, path, step, X, s, sigma, drag_old, drag_init, history, failures):
        save_checkpoint(
            path, step=step, X=_host(X), s=_host(s), sigma=sigma, drag_old=drag_old,
            extra={"drag_init": drag_init, "history_json": json.dumps([dataclasses.asdict(r) for r in history]),
                   "failures_json": json.dumps(failures)},
        )

    def _write_telemetry(self, telemetry, history, failures, drag_init, catalog_failures):
        """__Drag.txt, __Iterations_per_step.txt and __Failure_Data.txt over
        the whole accepted history (obstacle.py:1432-1463)."""
        cfg = self.cfg
        steps = [r.step for r in history]
        # 2D normalizes the shape-derivative column by scaling*sigma
        # (2d:1348); 3D stores it raw (3d:1343)
        telemetry.write_drag(
            steps, [r.drag for r in history], [r.drag / drag_init for r in history],
            [r.drag_diff for r in history],
            [r.shape_derivative / (r.scaling * r.sigma) if cfg.dim == 2 else r.shape_derivative for r in history],
        )
        telemetry.write_iterations(
            steps, [r.admm_iters for r in history], [r.sigma for r in history],
            [r.newton_iters for r in history], [r.lin_iters for r in history],
            solver_iters=[r.solver_iters for r in history], dim=cfg.dim,
        )
        if failures and catalog_failures:
            telemetry.write_failures(
                list(range(len(failures))), [f["step"] for f in failures], [f["drag"] for f in failures],
                [f["diff"] for f in failures], [f["sigma"] for f in failures],
            )

    def run(
        self,
        num_steps: int | None = None,
        telemetry=None,
        callback: Callable | None = None,
        verbose: bool = False,
        resume: dict | None = None,
        checkpoint_path: str | None = None,
        profiler: Profiler | None = None,
        catalog_failures: bool = True,
        admm_iter_cb: Callable | None = None,
    ) -> list[StepRecord]:
        """The optimization loop; returns the accepted steps' records (with
        a resume that carries history_json, the restored ones first).

        resume: {"X" (V, d), "s", "sigma", "step", "drag_old"[, "drag_init",
        "history_json", "failures_json"]}, as io.checkpoint.load_checkpoint
        returns it (numpy) or convert.resume_state makes it: the loop starts
        at step + 1 from that state instead of the cold-start ladder, with
        the warm sidecar of checkpoint_path if there is one.
        telemetry: an io.telemetry.TelemetryWriter; checkpoint_path: the
        checkpoint written after the ladder (as step -1) and after every
        accepted step, with its sidecar <checkpoint_path>.warm.npz;
        profiler: a utils.profiling.Profiler fed by the step's phases;
        catalog_failures: keep rejected (non-descent) attempts in
        __Failure_Data.txt with a failed_flows VTU each.
        callback(step, X, s, rec) after every accepted step;
        admm_iter_cb(step, attempt, k, u) with every ADMM iterate's global
        u (d, V) (-bOutputIntermediateUp, 2d:84).

        self.step_log gets one entry per step: "seconds", "launches" and
        "by_lattice" per phase (adjoint, jprime, assemble, admm, min_det,
        ns_solve, drag), "adjoint" (iterations, exit), "ns" per re-solve
        (Newton and linear counts) and "attempts" (per attempt its outcome
        and what it halved)."""
        cfg = self.cfg
        prof = profiler if profiler is not None else Profiler()
        num_steps = cfg.num_steps if num_steps is None else num_steps
        history: list[StepRecord] = []
        failures: list[dict] = []
        if resume is not None:
            X = torch.as_tensor(resume["X"], dtype=self.dtype, device=self.device).contiguous()
            s = torch.as_tensor(resume["s"], dtype=self.dtype, device=self.device)
            sigma = float(resume["sigma"])
            drag_old = float(resume["drag_old"])
            start_step = int(resume["step"]) + 1
            self.drag_init = float(resume.get("drag_init", drag_old))
            if checkpoint_path is not None:
                self._load_warm_sidecar(checkpoint_path)
            # the accepted history, so that the telemetry files stay
            # contiguous across restarts (one __Drag.txt for the whole run)
            for rd in json.loads(str(resume.get("history_json", "[]"))):
                rd["solver_iters"] = tuple(rd.get("solver_iters", ()))
                history.append(StepRecord(**rd))
            failures = json.loads(str(resume.get("failures_json", "[]")))
        else:
            X = self.X0
            s = self._ladder(verbose)
            drag_old = self._drag(X, s)
            sigma = cfg.sigma_threshold
            start_step = 0
            self.drag_init = drag_old  # the normalizer of the drag telemetry
            if checkpoint_path is not None:
                # the state after the ladder as "step -1": the ladder is the
                # longest stretch without a checkpoint
                self._checkpoint(checkpoint_path, -1, X, s, sigma, drag_old, drag_old, [], [])
        drag_init = self.drag_init
        fc = cfg.admm_failure_control
        if fc == "auto":
            fc = "scaling" if cfg.dim == 3 else "sigma"

        def vtu(name, coords, fields):
            if telemetry is not None:
                write_vtu(f"{telemetry.out_dir}/{name}.vtu", _host(coords), _host(self.elems),
                          point_data={k: _host(v) for k, v in fields.items()})

        for step in range(start_step, num_steps):
            t0 = time.perf_counter()
            ph = _Phases(self.device, prof)
            log = dict(step=step, seconds=ph.seconds, launches=ph.launches, by_lattice=ph.by_lattice,
                       attempts=[], ns=[])
            self.step_log.append(log)
            if cfg.debug_output and telemetry is not None:
                # SaveGridLevelToFile parity (2d:788): per-step mesh dump
                self._write_mesh_ugx(f"{telemetry.out_dir}/Mesh_lev{cfg.num_refs}_step{step}.ugx", X)
            adj = ph("adjoint", lambda: ns_run.adjoint(
                self.ns, s, X=X, lam0=self._cur_lam_adj, recycle=self._adj_recycle))
            log["adjoint"] = dict(iters=adj.iters, exit=adj.exit, res_norm=adj.res_norm, target=adj.target)
            if verbose:
                print(f"  adjoint: {adj.iters} its |r|={adj.res_norm:.2e} ({adj.exit})", flush=True)
            if cfg.debug_nans:
                debug.check_finite("adjoint", lam_adj=adj.lam)
            Jp = ph("jprime", lambda: ns_run.jprime(self.ns, s, adj.lam, X=X))
            if cfg.debug_nans:
                debug.check_finite("jprime", Jp=Jp)
            self._cur_lam_adj, self._cur_Jp = adj.lam, Jp
            self._cur_X, self._cur_s = X, s
            scaling = cfg.scaling  # reset each step (reference 2d:807)
            accepted = False
            attempts = 0
            while not accepted and attempts < cfg.max_attempts_per_step:
                attempts += 1
                rec_a = dict(attempt=attempts, sigma=sigma, scaling=scaling, halved=None)
                log["attempts"].append(rec_a)
                mgdata = ph("assemble", lambda: xupdate_solve.assemble(self.xu, X))
                if cfg.debug_nans:
                    debug.check_finite("assemble", **{f"mgdata_leaf{i}": t for i, t in enumerate(_tensors(mgdata))})
                icb = None if admm_iter_cb is None else (
                    lambda k, u, _s=step, _a=attempts: admm_iter_cb(_s, _a, k, u))
                newton_hist = [] if cfg.newton_output and telemetry is not None else None
                full_stats = []
                debug_out = {} if cfg.debug_output and telemetry is not None else None
                res = ph("admm", lambda: self._admm(mgdata, X, Jp, sigma, scaling, iter_cb=icb,
                                                    newton_hist_out=newton_hist, full_stats_out=full_stats,
                                                    debug_out=debug_out))
                if cfg.debug_nans:
                    debug.check_finite("admm", u=res.u, lam=res.lam)
                rec_a.update(admm_it=res.admm_it, newton=res.total_newton, krylov=res.total_lin_iters)
                if res.failed:
                    # 2d:1269 halves sigma; 3d:1322 halves scaling instead
                    rec_a.update(outcome="ADMM failed", halved=fc)
                    if fc == "scaling":
                        scaling *= 0.5
                    else:
                        sigma *= 0.5
                    if verbose:
                        print(f"step {step}: ADMM failed, {fc} -> {scaling if fc == 'scaling' else sigma}")
                    continue
                X_new = (X + res.u.T).contiguous()
                if ph("min_det", lambda: self._min_det(X_new)) <= 0.0:
                    sigma *= 0.5
                    rec_a.update(outcome="tangled", halved="sigma")
                    if verbose:
                        print(f"step {step}: mesh tangled, sigma -> {sigma}")
                    continue
                nres, _ = ph("ns_solve", lambda: ns_run.newton(self.ns, s, recycle=self._ns_recycle, X=X_new))
                if cfg.debug_nans:
                    debug.check_finite("ns_solve", s=nres.s)
                log["ns"].append(dict(iters=nres.iters, lin_iters=list(nres.lin_iters), res_norm=nres.res_norm,
                                      converged=nres.converged))
                if not nres.converged:
                    sigma *= 0.5
                    rec_a.update(outcome="NS diverged", halved="sigma")
                    if verbose:
                        print(f"step {step}: NS diverged ({nres.res_norm:.2e}), sigma -> {sigma}")
                    continue
                drag_new = ph("drag", lambda: self._drag(X_new, nres.s))
                shape_deriv = float(res.scaling * torch.sum(Jp * res.u))
                ddiff = drag_new - drag_old
                rec_a.update(drag=drag_new, drag_diff=ddiff, shape_derivative=shape_deriv)
                # descent test (reference 2d:1300-1306)
                if ddiff > 0.0 or ddiff > cfg.line_search_param * shape_deriv:
                    failures.append(dict(step=step, drag=drag_new, diff=ddiff, sigma=sigma))
                    if catalog_failures:
                        # failed-field VTU (reference 2d:1317-1321)
                        vtu(f"failed_flows_step_{step}_failure_{len(failures) - 1}", X, {"u_fail": res.u.T})
                    sigma *= 0.5  # revert is implicit: X unchanged
                    rec_a.update(outcome="not a descent", halved="sigma")
                    if verbose:
                        print(f"step {step}: not a descent ({ddiff:+.3e}), sigma -> {sigma}")
                    continue
                X, s, drag_old = X_new, nres.s, drag_new
                accepted = True
                rec_a["outcome"] = "accepted"
                rec = StepRecord(
                    step=step, drag=drag_new, drag_diff=abs(ddiff), shape_derivative=shape_deriv,
                    sigma=sigma, scaling=float(res.scaling), admm_iters=res.admm_it,
                    newton_iters=res.total_newton, lin_iters=res.total_lin_iters, attempts=attempts,
                    wall_time=time.perf_counter() - t0, solver_iters=tuple(int(v) for v in res.solver_iters),
                )
                history.append(rec)
                if verbose:
                    print(f"step {step}: drag {drag_new:.6f} ({ddiff:+.2e}) admm={rec.admm_iters} "
                          f"newton={rec.newton_iters} sigma={sigma} [{rec.wall_time:.2f}s]", flush=True)
                if telemetry is not None:
                    telemetry.log_step(dataclasses.asdict(rec))
                    # every ADMM stats row, across fake-convergence restarts
                    # (2d:1221); the state's table when none was kept
                    stats = np.asarray(full_stats) if full_stats else res.stats.numpy()[: max(res.admm_it, 1)]
                    telemetry.write_admm_stats(step, {f"c{i}": stats[:, i].tolist() for i in range(stats.shape[1])})
                    if newton_hist is not None:
                        # written even when the last ADMM iteration applied
                        # no Newton row (the reference writes unconditionally)
                        telemetry.write_newton_stats(step, newton_hist)
                        telemetry.write_newton_iterations(step, newton_hist)
                    if debug_out:
                        # -bDebugOutput VTUs (2d:962-1076): the last Newton
                        # iteration's Lu, large-problem RHS and increment
                        vtu(f"ConsistentLu_step_{step}", X, {"up": debug_out["Lu"].T})
                        vtu(f"RHSBigProb_{step}", X, {"up": debug_out["rhs_large"].T})
                        vtu(f"delta_u_step_{step}", X, {"u": debug_out["du"].T})
                    if cfg.debug_nodal_positions:
                        # -bDebugNodalPositions (3d:1393-1399)
                        vtu(f"grid_positions_step_{step}", X, {"u": X})
                    self._write_telemetry(telemetry, history, failures, drag_init, catalog_failures)
                if checkpoint_path is not None:
                    self._checkpoint(checkpoint_path, step, X, s, sigma, drag_old, drag_init, history, failures)
                    self._save_warm_sidecar(checkpoint_path)
                if callback is not None:
                    callback(step, X, s, rec)
                if profiler is not None and verbose:
                    # the cumulative breakdown after every accepted step: a
                    # killed process keeps it in its log
                    print(prof.report(), flush=True)
            if not accepted:
                if verbose:
                    print(f"step {step}: no acceptable step found, stopping")
                break
        self.X_final = X
        self.s_final = s
        return history
