"""Requests of the ``admm_inner`` kind: one whole ADMM inner loop each,
``admm_optim_tpu_torch.admm_run.run`` (``optim.admm.admm_inner`` on
``optim.spaces.PatchOps``) from the zero state (u = 0, lambda = q = 0,
Lambda = 0), on a context made by ``xupdate_solve.prepare`` and
``xupdate_solve.assemble`` from the benchmark's own mesh with the
configuration's x-update operator (c_grad = tau).

The shape gradients J' are the traffic's pool (benchmark.pools: normal,
zero on the Dirichlet vertices, times the pool's scale), made in vertex
layout from the seed and converted once with the port's ``to_patch``;
request i takes pool entry i mod size.  A request ends when the loop
returns and the device has finished.  It is sound (``ok``) when it ran all
``admm_steps`` iterations and its last x-update's Newton converged (with
``admm_tolerance`` 0 the loop itself ends flagged failed at its last
iteration, so that flag tells nothing).

The check (benchmark.admm_reference, float64): from each sampled request's
own iterates u_1..u_K, handed back through ``iter_cb`` with their Lambda_k,
the reference rebuilds q_K and lambda_K and compares them with the
program's element by element (``lam_q_err``), bounds the x-update's
stationarity residual at every iterate with the program's own Lambda_k
(``stationarity_max``) and the constraint defects g(u_k) - g(0) at every
iterate (``feasibility_max``).  The per-cell tensors map to the mesh's
tets through the patch set's element map (``admm_reference.patch_elements``),
held to be the mesh's tets.
"""
from __future__ import annotations

import gc
import inspect
import time

import numpy as np
import torch

from .. import admm_reference, meshgen
from . import common

DTYPES = {"float32": torch.float32, "float64": torch.float64}
CONTROL = "bf16"
FAULTS = ("state_unchanged", "answer_altered", "dlambda_zero")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class Planted:
    """An operator bundle with a control or a fault planted under the timed
    path; every attribute the loop reads is the bundle's own, but for the
    methods below.

    "bf16" (the control, with the operator rounded in place by the driver):
    q and lambda rounded to bfloat16 where they are made, and the
    constraint values rounded at their own size (the volume and the
    barycenters before the targets are taken off); "state_unchanged": the
    dual update leaves lambda as it was; "answer_altered": the z-prox's
    largest element of q moved by 1% of it; "dlambda_zero": the Schur
    update's DLambda dropped (the Gram column of B . st replaced by g, the
    constraint values read just before it, so that S^-1 (g - B . st) = 0)."""

    def __init__(self, ops, variant: str):
        self._ops, self._variant, self._g = ops, variant, None

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def constraints(self, u, ref_volume, ref_barycenter):
        g = self._ops.constraints(u, ref_volume, ref_barycenter)
        if self._variant == CONTROL:
            refs = torch.cat([ref_volume.reshape(1), ref_barycenter])
            g = _bf16(g + refs) - refs
        self._g = g
        return g

    def dot_batch(self, Xs, Ys):
        G = self._ops.dot_batch(Xs, Ys)
        if self._variant == "dlambda_zero":
            G = torch.cat([self._g[:, None], G[:, 1:]], dim=1)
        return G

    def z_update(self, u, lam, tau, sigma, norm_name):
        q = self._ops.z_update(u, lam, tau, sigma, norm_name)
        if self._variant == CONTROL:
            return _bf16(q)
        if self._variant == "answer_altered":
            flat = q.reshape(-1).clone()
            j = flat.abs().argmax()
            flat[j] = flat[j] * 1.01
            return flat.reshape(q.shape)
        return q

    def dual_update(self, u, lam, q_proj, tau):
        lam_new, inc = self._ops.dual_update(u, lam, q_proj, tau)
        if self._variant == "state_unchanged":
            return lam, torch.zeros_like(inc)
        if self._variant == CONTROL:
            return _bf16(lam_new), inc
        return lam_new, inc


class Driver:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, device, log):
        self.config, self.traffic, self.limits, self.seed = config, traffic, limits, seed
        self.device = torch.device(device)
        self.log = log
        self.dtype = DTYPES[config["precision"]["operator"]]
        self.program = None  # the port's context, problem, pool in patch layout, entry point
        self.lattice = None  # (gid, class_offsets) of the fine patch level, kept for the check
        self._tets = None

    def setup(self) -> dict:
        from admm_optim_tpu_torch import admm_run
        from admm_optim_tpu_torch.ops import patchstencil as st
        from admm_optim_tpu_torch.optim import admm

        if not {"Jp", "iter_cb", "prob"} <= set(inspect.signature(admm_run.run).parameters):
            raise RuntimeError("admm_run.run takes no given J', iter_cb and problem: this program cannot "
                               "run the admm_inner requests")
        cfg = admm.ADMMConfig(**self.config["admm"], c_eps=self.config["operator"]["c_eps"],
                              c_mass=self.config["operator"]["c_mass"])
        if self.config["operator"]["c_grad"] != cfg.tau:
            raise RuntimeError(f"the x-update operator's c_grad {self.config['operator']['c_grad']} "
                               f"is not the ADMM tau {cfg.tau}")
        ctx, self.fine, parts = self.build_context()
        t0 = time.perf_counter()
        prob = admm_run.problem(ctx)
        pool = [st.to_patch(ctx.ps.fine, b.to(self.dtype)) for b in self.pool_vertex(self.seed)]
        common.sync(self.device)
        parts["problem_s"] = time.perf_counter() - t0
        self.lattice = (ctx.ps.fine.gid, ctx.ps.class_offsets)
        self.program = dict(ctx=ctx, cfg=cfg, base=prob, prob=prob, pool=pool, run=admm_run.run, st=st)
        t0 = time.perf_counter()
        for i in range(int(self.traffic["warmup_requests"])):
            rec, _ = self.request(i)
            self.log(f"warm-up request {i}: {rec['seconds']:.3f} s, ADMM {rec['admm_it']}, Newton {rec['newton']}, "
                     f"lane CG {rec['lin_iters']}, ok {rec['ok']}")
        parts["warmup_s"] = time.perf_counter() - t0
        return parts

    def build_context(self) -> tuple:
        """(ctx with its data assembled, the fine level's arrays, set-up
        parts), in the configuration's precision."""
        parts = {}
        t0 = time.perf_counter()
        from admm_optim_tpu_torch import _build, xupdate_solve
        from admm_optim_tpu_torch.core.mesh import Hierarchy, MeshLevel

        parts["import_s"] = time.perf_counter() - t0
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            compile_s, _ = _build.build()
            _build.lib()
            parts["kernels_s"] = time.perf_counter() - t0
            parts["nvcc_s"] = compile_s
        op, vc = self.config["operator"], self.config["vcycle"]
        if list(xupdate_solve.DIRICHLET) != op["dirichlet"]:
            raise RuntimeError(f"xupdate_solve.DIRICHLET {xupdate_solve.DIRICHLET} differs "
                               f"from the configuration's {op['dirichlet']}")
        levels, info = meshgen.load_levels(self.config["mesh"]["refs"], log=self.log)
        parts["mesh_s"] = info["seconds"]
        common.check_sizes(self.config, levels)
        t0 = time.perf_counter()
        hier = Hierarchy([MeshLevel(dim=3, **lvl) for lvl in levels])
        ctx = xupdate_solve.prepare(
            hier, self.device, self.dtype, c_eps=op["c_eps"], c_grad=op["c_grad"], c_mass=op["c_mass"],
            smoothing=dict(pre_smooth=vc["pre_smooth"], post_smooth=vc["post_smooth"], cheb_lower=vc["cheb_lower"]))
        parts["prepare_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ctx.data = xupdate_solve.assemble(ctx, ctx.coords)
        common.sync(self.device)
        parts["assembly_s"] = time.perf_counter() - t0
        common.check_stream(self.config, ctx, self.device)
        return ctx, levels[-1], parts

    def pool_vertex(self, seed: int) -> torch.Tensor:
        return common.pool_vertex(self.config, self.traffic, self.fine, seed, self.device)

    def set_pool(self, seed: int):
        st, ps = self.program["st"], self.program["ctx"].ps
        self.program["pool"] = [st.to_patch(ps.fine, b.to(self.dtype)) for b in self.pool_vertex(seed)]

    def plant(self, variant: str):
        """Put the control or a fault under the timed path (Planted;
        benchmark.control_admm): "bf16" also rounds every level's stencil
        to bfloat16 in place, for good; "program" takes the bundle as it is."""
        p = self.program
        base = p["base"]
        if variant == "program":
            p["prob"] = base
            return
        if variant not in (CONTROL,) + FAULTS:
            raise ValueError(f"unknown variant {variant!r}")
        if variant == CONTROL:
            for w in p["ctx"].data.W:
                w.copy_(_bf16(w))
        p["prob"] = base._replace(ops=Planted(base.ops, variant))

    def request(self, i: int):
        p = self.program
        k = i % len(p["pool"])
        us, Lambdas = [], []

        def keep(n, u, Lambda):
            us.append(u)
            Lambdas.append(Lambda)

        t0 = time.perf_counter()
        out = p["run"](p["ctx"], p["cfg"], Jp=p["pool"][k], iter_cb=keep, prob=p["prob"])
        common.sync(self.device)
        dt = time.perf_counter() - t0
        s = out.state
        rec = dict(seconds=dt, ok=s.admm_it == p["cfg"].admm_steps and not s.newton_failed, admm_it=s.admm_it,
                   newton=s.total_newton, lin_iters=s.total_lin_iters, lin_each=list(s.solver_iters),
                   batch_iters=s.batch_iters, pool_index=k, index=i)
        return rec, dict(us=us, Lambdas=Lambdas, lam=s.lam, q=s.q_proj)

    def log_window(self, requests: list):
        s = np.array([r["seconds"] for r in requests])
        seen = sorted({(r["admm_it"], r["newton"], r["lin_iters"]) for r in requests})
        self.log(f"loops {len(requests)}: s min {s.min():.4f} median {np.median(s):.4f} max {s.max():.4f}; "
                 f"(ADMM, Newton, lane CG) seen {seen}")
        self.log("loop s in order: " + " ".join(f"{v:.3f}" for v in s))

    def answer_vertex(self, answer: dict) -> tuple:
        """A request's answer -> (us (3, V), Lambdas (4,), lambda_K and q_K
        (3, 3, N) in the order of the patch element map), float64."""
        st, ps = self.program["st"], self.program["ctx"].ps
        V = len(self.fine["coords"])
        us = [st.from_patch(ps.fine, u.double(), V) for u in answer["us"]]
        flat = [answer[k].double().reshape(3, 3, -1) for k in ("lam", "q")]
        return us, [L.double() for L in answer["Lambdas"]], *flat

    def release(self, kept: list):
        """Hand each kept answer back in vertex layout, then free the
        program's state."""
        for n, (rec, answer) in enumerate(kept):
            kept[n] = (rec, self.answer_vertex(answer))
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def tets(self) -> admm_reference.Tets:
        """The mesh's tets in the order of the patch element map, once held
        to be the mesh's own."""
        if self._tets is None:
            elems = admm_reference.patch_elements(*self.lattice)
            free = ~meshgen.dirichlet_mask(self.fine, self.config["operator"]["dirichlet"])
            tets = admm_reference.Tets(self.fine["coords"], elems, free, self.device)
            if not admm_reference.same_tets(tets.elems, torch.as_tensor(self.fine["elems"], device=self.device)):
                raise RuntimeError("the patch element map does not hold the mesh's tets")
            self._tets = tets
        return self._tets

    def readings(self, kept: list, pool: torch.Tensor) -> dict:
        """The numbers the check compares, over answers in vertex layout."""
        a, op = self.config["admm"], self.config["operator"]
        got = admm_reference.readings(
            self.tets(), (op["c_eps"], op["c_grad"], op["c_mass"]),
            [pool[rec["pool_index"]].double() for rec, _ in kept], [ans for _, ans in kept],
            a["tau"], a["sigma_threshold"], a["scaling"])
        for rec, _ in kept:
            self.log(f"request {rec['index']} (pool {rec['pool_index']}): ADMM {rec['admm_it']}, "
                     f"Newton {rec['newton']}, lane CG {rec['lin_iters']}")
        self.log("readings against the float64 reference: " + ", ".join(f"{k} {v:.6e}" for k, v in got.items()))
        return {k: common.finite(v) for k, v in got.items()}

    def check(self, kept: list) -> dict:
        values = self.readings(kept, self.pool_vertex(self.seed))
        return {k: {"value": v, "limit": self.limits["limits"][k]} for k, v in values.items()}
