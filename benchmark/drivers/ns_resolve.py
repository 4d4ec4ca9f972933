"""Requests of the ``ns_resolve`` kind: the Navier-Stokes re-solve of an
accepted optimization step, as ``models/obstacle.py`` runs it once a step:
``ns_run.newton(ctx, s, recycle=..., X=X_new)`` on the deformed mesh, then
the drag ``nsops.drag`` there.

Set-up makes ``ctx`` with ``ns_run.build`` from the benchmark's own mesh
and the configuration's NS settings (the ProblemConfig defaults: mass
pressure block, one velocity V-cycle, the assembled Jacobian, the float32
Newton presets; each Newton iterate's Jacobian and preconditioner applies
replayed from CUDA graphs), checks that the program runs as the
configuration states,
and runs the cold-start viscosity ladder ``ns_run.solve_ladder`` once; its
state s* and recycle space U* are every request's start.

The deformed meshes are the traffic's pool, made from the seed in vertex
layout: d_i(x) = phi(x) M_i (x - c), c the obstacle's centre, phi = (1 -
|x - c|^2 / R^2)^2 inside the radius R and 0 outside, M_i a normal 3 x 3
matrix scaled to the pool's Frobenius norm.  Request i re-solves on X +
d_(i mod size) from s* with a fresh {"U": U*}, then takes the drag; it
ends when the drag is on the host.  It is sound (``ok``) when Newton
converged and the drag is finite.

The check (benchmark.ns_reference, float64 on the same device), on each
sampled request's own mesh X_i and returned state s_i: ``ns_res_rel`` =
|R(s_i; X_i)| / |R(s_cold; X_i)|, s_cold the inlet data and zero
elsewhere, and ``drag_err`` = |drag - J(s_i; X_i)| / |J(s_i; X_i)|, the
program's drag against the reference's.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from .. import meshgen, ns_reference, pools
from . import common

DTYPES = {"float32": torch.float32, "float64": torch.float64}
CONTROL = "bf16"
FAULTS = ("state_unchanged", "mesh_stale", "one_iterate")


def deformations(seed: int, pool: dict, coords: torch.Tensor, centre) -> torch.Tensor:
    """(size, V, 3) float64 bumps d_i(x) = phi(x) M_i (x - c) on coords
    (V, 3) float64, from seed, on coords' device."""
    gen = pools.generator(seed, coords.device)
    M = torch.randn((int(pool["size"]), 3, 3), generator=gen, device=coords.device, dtype=torch.float64)
    M = M * (float(pool["frobenius"]) / torch.linalg.matrix_norm(M))[:, None, None]
    y = coords - torch.as_tensor(centre, dtype=torch.float64, device=coords.device)
    phi = torch.clamp_min(1.0 - (y * y).sum(dim=1) / float(pool["radius"]) ** 2, 0.0) ** 2
    return phi[None, :, None] * torch.einsum("kij,vj->kvi", M, y)


class Driver:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, device, log):
        self.config, self.traffic, self.limits, self.seed = config, traffic, limits, seed
        self.device = torch.device(device)
        self.log = log
        self.dtype = DTYPES[config["precision"]["operator"]]
        self.program = None  # the port's context, the ladder's state and recycle space, the entry points
        self.fine = None  # the fine level's mesh arrays
        self.X_pool = None  # (size, V, 3) the pool's meshes in the program's precision
        self._mesh = None

    # -- set-up ----------------------------------------------------------
    def setup(self) -> dict:
        parts = {}
        t0 = time.perf_counter()
        from admm_optim_tpu_torch import _build, ns_run
        from admm_optim_tpu_torch.core.mesh import Hierarchy, MeshLevel
        from admm_optim_tpu_torch.ops import navier_stokes as nsops

        parts["import_s"] = time.perf_counter() - t0
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            compile_s, _ = _build.build()
            _build.lib()
            parts["kernels_s"] = time.perf_counter() - t0
            parts["nvcc_s"] = compile_s
        ns = self.config["ns"]
        levels, info = meshgen.load_levels(self.config["mesh"]["refs"], log=self.log)
        parts["mesh_s"] = info["seconds"]
        self.fine = levels[-1]
        t0 = time.perf_counter()
        hier = Hierarchy([MeshLevel(dim=3, **lvl) for lvl in levels])
        ctx = ns_run.build(hier=hier, device=self.device, dtype=self.dtype, visc=ns["visc"], stab=ns["stab"],
                           pressure_precond=ns["pressure_precond"], vel_inner=ns["vel_inner"],
                           do_nothing=ns["do_nothing"], diameter=ns["diameter"], vorder=ns["vorder"],
                           ns_jac_mem_cap=ns["ns_jac_mem_cap"], graphs=ns["graphs"])
        common.sync(self.device)
        parts["build_s"] = time.perf_counter() - t0
        self.check_program(ctx, ns_run, levels)
        ns_reference.check_layout(self.mesh(), ctx.coords, nsops.vel_dof_coords(ctx.space, ctx.coords))

        t0 = time.perf_counter()
        lad = ns_run.solve_ladder(ctx, start=ns["ladder_start"])
        common.sync(self.device)
        parts["ladder_s"] = time.perf_counter() - t0
        for r in lad.rungs:
            self.log(f"ladder rung visc {r.nu:g}{' (inserted)' if r.inserted else ''}: Newton {r.newton.iters}, "
                     f"linear {r.newton.lin_iters}, |R| {r.newton.res_norm:.3e}, converged {r.newton.converged}, "
                     f"{r.seconds:.3f} s")
        self.program = dict(ctx=ctx, s_star=lad.s, U_star=lad.recycle.get("U"), newton=ns_run.newton,
                            drag=nsops.drag, variant="program")
        self.set_pool(self.seed)
        t0 = time.perf_counter()
        for i in range(int(self.traffic["warmup_requests"])):
            rec, _ = self.request(i)
            self.log(f"warm-up request {i}: {rec['seconds']:.3f} s, Newton {rec['newton']}, "
                     f"linear {rec['lin_iters']}, ok {rec['ok']}")
        parts["warmup_s"] = time.perf_counter() - t0
        return parts

    def check_program(self, ctx, ns_run, levels: list):
        """The program runs as the configuration states, or not at all."""
        exp, ns, lat = self.config["expect"], self.config["ns"], self.config["lattice"]
        fine = levels[-1]
        got = dict(levels=len(levels), vertices=len(fine["coords"]), edges=len(fine["edges"]),
                   tets=len(fine["elems"]), dofs=ctx.n_state, level0_vertices=len(levels[0]["coords"]),
                   velocity_lattice=ctx.pre_ps.fine.m + 1, pressure_lattice=ctx.ps.fine.m + 1, patches=ctx.ps.P)
        for key, val in got.items():
            if exp[key] != val:
                raise RuntimeError(f"{key} {val} != the configuration's {exp[key]}")
        if (len(ctx.pre_ps.levels), len(ctx.ps.levels)) != (lat["velocity_levels"], lat["pressure_levels"]):
            raise RuntimeError(f"lattice levels {len(ctx.pre_ps.levels)}, {len(ctx.ps.levels)} differ from the "
                               f"configuration's {lat['velocity_levels']}, {lat['pressure_levels']}")
        if ctx.assembled != (ns["jacobian"] == "assembled"):
            raise RuntimeError(f"the program's Jacobian is {'assembled' if ctx.assembled else 'matrix-free'}, "
                               f"the configuration's {ns['jacobian']}")
        if (ctx.backend, ctx.pressure_precond, ctx.vel_inner) != ("patch", ns["pressure_precond"], ns["vel_inner"]):
            raise RuntimeError(f"the program runs backend {ctx.backend}, pressure block {ctx.pressure_precond}, "
                               f"vel_inner {ctx.vel_inner}; the configuration patch, {ns['pressure_precond']}, "
                               f"{ns['vel_inner']}")
        graphed = getattr(ctx, "graphed", False)
        if graphed != ns["graphs"]:
            raise RuntimeError(f"the program's Newton linear solves replay CUDA graphs: {graphed}; the "
                               f"configuration's: {ns['graphs']}")
        if dataclasses.asdict(ctx.cfg) != ns["newton"]:
            raise RuntimeError(f"the program's Newton settings {dataclasses.asdict(ctx.cfg)} differ from the "
                               f"configuration's {ns['newton']}")
        if list(ns_run.NS_DIR) != ns["dirichlet"]:
            raise RuntimeError(f"the program's velocity Dirichlet set {ns_run.NS_DIR} differs from the "
                               f"configuration's {ns['dirichlet']}")
        nq = (len(ctx.space.qw), len(ctx.space.drag_qw))
        want = tuple(len(ns_reference.rule(q)[1]) for q in (ns_reference.QUAD5, ns_reference.QUAD3))
        if (ns["quad_degree"], ns["drag_quad_degree"]) != (5, 3) or nq != want:
            raise RuntimeError(f"the program's quadrature has {nq} points, degrees 5 and 3 have {want}")

    def mesh(self) -> ns_reference.Mesh:
        if self._mesh is None:
            self._mesh = ns_reference.Mesh(self.fine, self.device)
        return self._mesh

    # -- the pool --------------------------------------------------------
    def pool_vertex(self, seed: int) -> torch.Tensor:
        """(size, V, 3): the pool's deformed meshes X + d_i, in the
        program's precision; raises where a bump does not vanish on the
        pool's zero_on subsets."""
        pool = self.traffic["pool"]
        X = torch.as_tensor(np.asarray(self.fine["coords"], np.float64), device=self.device)
        box = np.asarray(self.config["mesh"]["obstacle"], np.float64)
        d = deformations(seed, pool, X, box.mean(axis=0))
        zero = torch.as_tensor(meshgen.dirichlet_mask(self.fine, pool["zero_on"]), device=self.device)
        if float(d[:, zero].abs().max()) != 0.0:
            raise RuntimeError(f"the pool's deformations do not vanish on {pool['zero_on']}")
        return (X[None] + d).to(self.dtype).contiguous()

    def set_pool(self, seed: int):
        self.X_pool = self.pool_vertex(seed)

    def plant(self, variant: str):
        """Put the control or a fault under the timed path
        (benchmark.control_ns): "state_unchanged" returns s* without a
        solve; "mesh_stale" solves with the residual and the Jacobian on the
        undeformed mesh; "one_iterate" stops Newton after one iterate; the
        control "bf16" rounds the returned state to bfloat16 (after the
        drag); "program" runs as the configuration states."""
        if variant not in ("program", CONTROL) + FAULTS:
            raise ValueError(f"unknown variant {variant!r}")
        self.program["variant"] = variant

    # -- a request -------------------------------------------------------
    def solve(self, X):
        p = self.program
        ctx, variant = p["ctx"], p["variant"]
        if variant == "state_unchanged":
            return p["s_star"], True, 0, []
        if variant == "mesh_stale":
            X = ctx.coords
        elif variant == "one_iterate":
            ctx = dataclasses.replace(ctx, cfg=dataclasses.replace(ctx.cfg, max_iters=1))
        res, _ = p["newton"](ctx, p["s_star"], recycle={"U": p["U_star"]}, X=X)
        return res.s, res.converged, res.iters, list(res.lin_iters)

    def request(self, i: int):
        p = self.program
        k = i % len(self.X_pool)
        X = self.X_pool[k]
        t0 = time.perf_counter()
        s, converged, iters, lin = self.solve(X)
        drag = float(p["drag"](p["ctx"].space, X, s, p["ctx"].visc))
        common.sync(self.device)
        dt = time.perf_counter() - t0
        if p["variant"] == CONTROL:
            s = s.to(torch.bfloat16).to(s.dtype)
        rec = dict(seconds=dt, ok=bool(converged) and math.isfinite(drag), newton=iters, lin_iters=sum(lin),
                   lin_each=lin, drag=drag, pool_index=k, index=i)
        return rec, dict(s=s, drag=drag)

    def log_window(self, requests: list):
        s = np.array([r["seconds"] for r in requests])
        seen = [(r["newton"], r["lin_iters"]) for r in requests]
        self.log(f"re-solves {len(requests)}: s min {s.min():.4f} median {np.median(s):.4f} max {s.max():.4f}; "
                 f"(Newton, linear) in order {seen}")
        self.log("re-solve s in order: " + " ".join(f"{v:.3f}" for v in s))
        self.log("drag in order: " + " ".join(f"{r['drag']:.9g}" for r in requests))

    # -- the check -------------------------------------------------------
    def answer_vertex(self, answer: dict) -> dict:
        """The answer as it is: the state is packed on the vertices and
        edges already."""
        return answer

    def release(self, kept: list):
        """Free the program's state; the kept answers stay."""
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, kept: list, pool: torch.Tensor) -> dict:
        """The numbers the check compares, over the kept answers on their
        pool meshes."""
        visc = self.config["ns"]["visc"]
        answers = [(pool[rec["pool_index"]], ans["s"], ans["drag"]) for rec, ans in kept]
        got = ns_reference.readings(self.mesh(), visc, answers)
        for rec, _ in kept:
            self.log(f"request {rec['index']} (pool {rec['pool_index']}): Newton {rec['newton']}, "
                     f"linear {rec['lin_iters']}, drag {rec['drag']:.9g}")
        self.log("readings against the float64 reference: " + ", ".join(f"{k} {v:.6e}" for k, v in got.items()))
        return {k: common.finite(v) for k, v in got.items()}

    def check(self, kept: list) -> dict:
        values = self.readings(kept, self.X_pool)
        return {k: {"value": v, "limit": self.limits["limits"][k]} for k, v in values.items()}
