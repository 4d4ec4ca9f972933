"""Requests of the ``ir_solve`` kind: one deformation solve each,
``admm_optim_tpu_torch.xupdate_solve.solve(ctx, b)`` (cg_ir_p to a 1e-8
true residual), on a context made by ``xupdate_solve.prepare`` and
``xupdate_solve.assemble`` from the benchmark's own mesh.

The right-hand sides are the traffic's pool (benchmark.pools), made in
vertex layout from the seed and converted once with the port's
``to_patch``; request i takes pool entry i mod size.  A request ends when
the solve returns and the device has finished.

The check: each sampled answer, handed back by the port in vertex layout
(its owner values), against the configuration's operator as the float64
reference assembles it from the mesh: the true relative residual.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import reference
from . import common


class Driver:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, device, log):
        self.config, self.traffic, self.limits, self.seed = config, traffic, limits, seed
        self.device = torch.device(device)
        self.log = log
        self.program = None  # the port's context, the pool in patch layout, its entry points

    def setup(self) -> dict:
        from admm_optim_tpu_torch import xupdate_solve
        from admm_optim_tpu_torch.ops import patchstencil as st

        ctx, self.fine, parts = common.build_context(self.config, self.device, self.log)
        t0 = time.perf_counter()
        pool = [st.to_patch(ctx.ps.fine, b) for b in self.pool_vertex(self.seed)]
        common.sync(self.device)
        parts["pool_s"] = time.perf_counter() - t0
        self.program = dict(ctx=ctx, pool=pool, solve=xupdate_solve.solve, st=st)
        t0 = time.perf_counter()
        for i in range(int(self.traffic["warmup_requests"])):
            rec, _ = self.request(i)
            self.log(f"warm-up request {i}: {rec['seconds'] * 1e3:.1f} ms, rounds {rec['rounds']}, "
                     f"CG {rec['inner_iters']}")
        parts["warmup_s"] = time.perf_counter() - t0
        return parts

    def pool_vertex(self, seed: int) -> torch.Tensor:
        return common.pool_vertex(self.config, self.traffic, self.fine, seed, self.device)

    def set_pool(self, seed: int):
        st, ps = self.program["st"], self.program["ctx"].ps
        self.program["pool"] = [st.to_patch(ps.fine, b) for b in self.pool_vertex(seed)]

    def plant(self, variant: str):
        """Put a control or a fault under the timed path (benchmark.control):
        "bf16_operator" rounds every level's stencil to bfloat16 in place;
        "state_unchanged" hands back the solve's starting iterate, zero;
        "answer_altered" scales the answer by 1 + 1e-2 where it is made;
        "one_round" stops after the first IR round, where the inner CG
        reaches its 1e-5, and reports the solve converged."""
        from admm_optim_tpu_torch import xupdate_solve
        from admm_optim_tpu_torch.solvers import patch_mg

        p = self.program
        p["solve"] = xupdate_solve.solve
        if variant == "bf16_operator":
            W = p["ctx"].data.W
            W[:] = [w.to(torch.bfloat16).to(w.dtype) for w in W]
        elif variant in ("state_unchanged", "answer_altered"):
            scale = 0.0 if variant == "state_unchanged" else 1.0 + 1e-2

            def broken(ctx, b):
                res = xupdate_solve.solve(ctx, b)
                return res._replace(x_hi=res.x_hi * scale, x_lo=res.x_lo * scale)

            p["solve"] = broken
        elif variant == "one_round":
            settings = dict(xupdate_solve.SOLVE_SETTINGS, max_rounds=1)

            def one_round(ctx, b):
                return patch_mg.cg_ir_p(ctx.struct, ctx.data, b, **settings)._replace(converged=True)

            p["solve"] = one_round
        elif variant != "program":
            raise ValueError(f"unknown variant {variant!r}")

    def request(self, i: int):
        p = self.program
        k = i % len(p["pool"])
        t0 = time.perf_counter()
        res = p["solve"](p["ctx"], p["pool"][k])
        common.sync(self.device)
        dt = time.perf_counter() - t0
        rec = dict(seconds=dt, ok=bool(res.converged), rounds=int(res.rounds),
                   inner_iters=int(res.inner_iters), pool_index=k, index=i)
        return rec, (res.x_hi, res.x_lo)

    def log_window(self, requests: list):
        its = sorted({(r["rounds"], r["inner_iters"]) for r in requests})
        ms = np.array([r["seconds"] for r in requests]) * 1e3
        self.log(f"solves {len(requests)}: ms min {ms.min():.3f} median {np.median(ms):.3f} "
                 f"max {ms.max():.3f}; (rounds, CG) seen {its}")
        self.log("solve ms in order: " + " ".join(f"{v:.1f}" for v in ms))

    def answer_vertex(self, answer) -> torch.Tensor:
        """An answer (x_hi, x_lo) in patch layout -> (3, V) float64, the
        owner values the port hands back."""
        st, ps = self.program["st"], self.program["ctx"].ps
        V = len(self.fine["coords"])
        xh, xl = answer
        return st.from_patch(ps.fine, xh.double(), V) + st.from_patch(ps.fine, xl.double(), V)

    def release(self, kept: list):
        """Hand each kept answer back in vertex layout, then free the
        program's state."""
        for n, (rec, answer) in enumerate(kept):
            kept[n] = (rec, self.answer_vertex(answer))
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, kept: list, pool: torch.Tensor) -> dict:
        """The numbers the check compares, over answers in vertex layout."""
        mesh = common.reference_mesh(self.config, self.fine, self.device)
        worst = 0.0
        for rec, x in kept:
            res = reference.rel_residual(mesh, common.coeffs(self.config), pool[rec["pool_index"]], x)
            self.log(f"request {rec['index']} (pool {rec['pool_index']}): true relative residual "
                     f"{res:.6e} against the float64 reference")
            worst = max(worst, common.finite(res))
        return {"true_res_max": worst}

    def check(self, kept: list) -> dict:
        values = self.readings(kept, self.pool_vertex(self.seed))
        return {k: {"value": v, "limit": self.limits["limits"][k]} for k, v in values.items()}
