"""The warm-started stepped adjoint (ns_solver.adjoint_solve_stepped with
lam0 and a recycle dict, as the optimization step calls it) against the
JAX package's obstacle.py _adjoint_stepped with the same lambda_0 and
GCRO-DR space U, float64 on the CPU, at the JAX package's converged visc
0.16 states of tests/goldens/ns_slice.npz (2D and 3D refs=1).  The JAX
results are goldens made by tests/goldens/make_e2e_goldens.py (adjoint).

Held: the iteration count (the k re-imaging applies of U included), the
exit, lambda to 1e-10 relative, and that the solve hands a recycle space of
rank k back.  Without a warm start the function is unchanged: lam0 = 0 and
an empty recycle dict give the cold result bit for bit (the NS slice and
ladder goldens of tests/test_torch_ns_slice.py and test_torch_ns_ladder.py
hold the cold result itself)."""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from admm_optim_tpu_torch import convert, ns_run
from admm_optim_tpu_torch.solvers.ns_solver import NewtonConfig

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).parent / "goldens"
GOLD = np.load(HERE / "adjoint_warm.npz")
SLICE = np.load(HERE / "ns_slice.npz")
VISC = 0.16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _ctx(dim, k):
    return ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=dim, cfg=NewtonConfig(adj_recycle_k=k))


@pytest.mark.parametrize("case,dim", [("2d_refs1", 2), ("3d_refs1", 3)])
def test_warm_adjoint_matches_jax(case, dim):
    k = int(GOLD[f"{case}_recycle_k"])
    ctx = _ctx(dim, k)
    s = convert.ns_state(SLICE[f"{case}_s"], "cpu")
    recycle = {"U": convert.tensor(GOLD[f"{case}_U"], "cpu")}
    adj = ns_run.adjoint(ctx, s, lam0=convert.ns_state(GOLD[f"{case}_lam0"], "cpu"), recycle=recycle)
    assert adj.iters == int(GOLD[f"{case}_iters"])
    assert adj.exit == "target" and adj.res_norm <= adj.target
    assert abs(adj.target - float(GOLD[f"{case}_target"])) <= 1e-10 * float(GOLD[f"{case}_target"])
    assert _rel(adj.lam, GOLD[f"{case}_lam"]) < 1e-10
    U = recycle["U"]
    assert U.shape == (k, ctx.n_state) and bool(torch.isfinite(U).all())


def test_cold_adjoint_is_unchanged_by_the_warm_start_arguments():
    """lam0 = 0 and an empty recycle dict take the cold path bit for bit;
    the dict then holds the space the cold solve left, and a recycle rank
    the cycle length cannot carry (rl < 8 k) leaves the dict empty."""
    ctx = _ctx(2, 8)
    s = convert.ns_state(SLICE["2d_refs1_s"], "cpu")
    cold = ns_run.adjoint(ctx, s)
    recycle = {}
    warm = ns_run.adjoint(ctx, s, lam0=torch.zeros_like(s), recycle=recycle)
    assert warm.iters == cold.iters and warm.exit == cold.exit and warm.res_norm == cold.res_norm
    assert torch.equal(warm.lam, cold.lam)
    assert recycle["U"].shape == (8, ctx.n_state)
    # the same U handed back to the cold solve's own lambda: already at the target
    again = ns_run.adjoint(ctx, s, lam0=cold.lam, recycle=recycle)
    assert again.iters == 8 and again.exit == "target"
    big = {}
    ns_run.adjoint(dataclasses.replace(ctx, cfg=NewtonConfig(adj_recycle_k=1000)), s, recycle=big)
    assert big == {}
