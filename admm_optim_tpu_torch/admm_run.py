"""The patch-backend ADMM inner loop end to end: the port's counterpart of
bench.py's ``admm_throughput``.

    ctx = xupdate_solve.build(4)   # on the card, float32; shared with the solve
    out = admm_run.run(ctx)   # BENCH_CFG: 5 ADMM iterations, CG x-solves
    out.state.admm_it, out.state.total_newton, out.seconds

    prob = admm_run.problem(ctx)   # the operator bundle and the constraint targets, once
    out = admm_run.run(ctx, cfg, Jp=Jp, iter_cb=cb, prob=prob)   # any ADMMConfig, a given J'

Each ADMM iteration runs the z-prox, the constrained Newton x-update (at
most ns_max_its iterations, 2 in BENCH_CFG, each one batched CG solve over
the 1+m = 5 lanes, preconditioned by the V-cycle on the stencils ``ctx``
keeps resident) and the dual ascent.  The shape gradient is random from a
seed, as bench.py makes it, unless one is given.  The operator is ctx's:
its c_grad stands for the ADMM step's tau.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .ops import patchstencil as st
from .ops.deformation import barycenter
from .ops.geometry import elem_geometry
from .optim import admm
from .optim.spaces import PatchOps
from .utils.profiling import span
from .xupdate_solve import DIRICHLET, SolveContext

# bench.py admm_throughput's settings: admm_tolerance 0 runs every iteration
BENCH_CFG = admm.ADMMConfig(
    admm_steps=5, admm_tolerance=0.0, tau=1.0, sigma_threshold=0.3, scaling=1.0, ns_max_its=2, ns_tol=1e-4,
    lin_max_iters=40, lin_abs_tol=1e-7, lin_rel_tol=1e-5, x_solver="cg",
)


class ADMMRun(NamedTuple):
    state: admm.ADMMState  # counters, flags and norms as the loop left them
    seconds: float  # wall time of admm_inner, synchronized


class Problem(NamedTuple):
    """What every run on one context shares."""

    ops: PatchOps  # the operator bundle over ctx's multigrid data
    ref_volume: torch.Tensor  # 0-d, the undeformed volume
    ref_barycenter: torch.Tensor  # (d,), the undeformed unnormalized barycenter


def _clock(t: torch.Tensor) -> float:
    """The host's clock once the device has finished: a host.sync span."""
    with span("host.sync"):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        return time.perf_counter()


def reference_targets(hier):
    """Volume and unnormalized barycenter of the undeformed fine mesh
    (the constraint targets, models/obstacle.py:291-294), float64 on the
    host (bench.py keeps them off the device): a 0-d and a (d,) tensor."""
    X = torch.as_tensor(hier.fine.coords, dtype=torch.float64)
    E = torch.as_tensor(hier.fine.elems.astype(np.int64))
    return elem_geometry(X, E)[3].sum(), barycenter(X, E, torch.zeros_like(X.T))


def shape_gradient(ctx: SolveContext, seed: int = 1) -> torch.Tensor:
    """Normal field from default_rng(seed), zero on Dirichlet vertices,
    times 0.01, in patch layout (bench.py's Jp_p)."""
    fine = ctx.hier.fine
    Jp = np.random.default_rng(seed).normal(size=(ctx.hier.dim, fine.num_vertices))
    Jp = torch.as_tensor(Jp, dtype=ctx.coords.dtype, device=ctx.coords.device)
    free = torch.as_tensor(~fine.vertex_mask(DIRICHLET), dtype=Jp.dtype, device=Jp.device)
    return st.to_patch(ctx.ps.fine, Jp * free) * 0.01


def problem(ctx: SolveContext) -> Problem:
    """PatchOps over ctx's multigrid data at ctx's coordinates, and the
    constraint targets in ctx's dtype on its device."""
    dev, dtype = ctx.coords.device, ctx.coords.dtype
    ref_vol, ref_bary = (torch.as_tensor(v, dtype=dtype, device=dev) for v in reference_targets(ctx.hier))
    return Problem(PatchOps(ctx.struct, ctx.data, st.to_patch(ctx.ps.fine, ctx.coords.T)), ref_vol, ref_bary)


def run(ctx: SolveContext, cfg: admm.ADMMConfig = BENCH_CFG, seed: int = 1, Jp: torch.Tensor | None = None,
        iter_cb=None, prob: Problem | None = None) -> ADMMRun:
    """admm_inner from the zero state at cfg's sigma_threshold and scaling,
    on prob (problem(ctx) if None), with the shape gradient Jp in patch
    layout (shape_gradient(ctx, seed) if None); iter_cb is admm_inner's."""
    prob = problem(ctx) if prob is None else prob
    Jp = shape_gradient(ctx, seed) if Jp is None else Jp
    t0 = _clock(Jp)
    state = admm.admm_inner(cfg, prob.ops, Jp, cfg.sigma_threshold, cfg.scaling, prob.ref_volume,
                            prob.ref_barycenter, iter_cb=iter_cb)
    return ADMMRun(state, _clock(Jp) - t0)
