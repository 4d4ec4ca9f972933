"""Bytes the ADMM inner loop's stencil applications need, counted from the
configuration and the program's per-lane iteration counts, on the
arithmetic of ``benchmark.cost`` (W in its storage read once, x read once
and y written once a lane).

An x-update Newton step of the lane-batched loop applies, on the fine
level, the operator A once to the iterate (its defect L_u), and runs one
CG solve over the 1 + m lanes of H = A + Lambda . g'' (the Hessian
stencil, float32 half stencil).  A batched solve runs as many iterations
as its longest lane, n; it applies H and the V-cycle n + 1 times (the
start residual and preconditioner, then one of each an iteration), each
time to every lane, streaming each stencil once for all lanes: K1 lanes
on the Hessian and on levels below the pencil stream, K3 on the bf16
pencil stream.  The program counts the steps (``ADMMState.total_newton``)
and the n summed over them (``ADMMState.batch_iters``).  A V-cycle applies 4 times a level above the base (one
pre-smoothing apply from zero, two post-smoothing, the restriction's
residual), ``cost.vcycle_applies``; the base is one dense matvec over the
lanes.  The count is of the work, whatever kernels implement it.
"""
from __future__ import annotations

from . import cost

F32 = cost.F32


def lanes(config: dict) -> int:
    """1 + m: the shape gradient's lane and one a constraint."""
    return 1 + len(config["constraints"])


def lane_apply_bytes(config: dict, level: int, stream: str, n_lanes: int) -> int:
    """One application on level to n_lanes fields: W once, each lane's x
    read and y written."""
    one = cost.apply_bytes(config, level, stream)
    g = cost.lattice(config, level)
    xy = 2 * g["C"] * g["sites"] * g["P"] * F32
    return one - xy + n_lanes * xy


def lane_vcycle_bytes(config: dict, n_lanes: int) -> int:
    refs = config["mesh"]["refs"]
    total = sum(cost.vcycle_applies(config) * lane_apply_bytes(config, l, cost.smoother_stream(config, l), n_lanes)
                for l in range(1, refs + 1))
    n0 = config["lattice"]["components"] * config["expect"]["level0_vertices"]
    return total + n0 * n0 * F32 + n_lanes * 2 * n0 * F32


def loop_bytes(config: dict, newton: int, batch_iters: int) -> int:
    """Least stencil bytes of one ADMM loop of `newton` Newton steps whose
    batched solves ran `batch_iters` iterations in all."""
    refs, n_lanes = config["mesh"]["refs"], lanes(config)
    per_iter = lane_apply_bytes(config, refs, "f32_sym", n_lanes) + lane_vcycle_bytes(config, n_lanes)
    return (batch_iters + newton) * per_iter + newton * cost.apply_bytes(config, refs, "f32_sym")
