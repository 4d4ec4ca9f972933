"""The goldens of the port's optimization step (tests/goldens/e2e_steps.npz,
made from the JAX package by tests/goldens/make_e2e_goldens.py) and what
the tests of models/obstacle.py hold against them.

What is held and why (obstacle_golden):
  * per step: accepted, attempts, sigma, scaling, the ADMM and x-update
    Newton counts, the x-update Krylov counts per step and per lane (within
    KRYLOV_REL), drag to 1e-8 relative (the re-solve stops at |R| ~1e-9,
    which moves the drag by ~1e-9);
  * the adjoint's exit at its target (the tests hold its count where the
    port starts as the JAX run did), and the number of NS re-solves per
    step, each converged.  The re-solves' linear counts are not held: they
    start from the GCRO-DR space the ladder's rungs carried, and past the
    ladder's first rung a change in the last bits moves the counts in
    either package (tests/test_torch_ns_ladder.py);
  * the JAX package's e2e invariants on the final mesh: volume to 1e-6
    relative, barycenter to 1e-5, no inverted element, the obstacle moved.

Imported by tests/test_torch_obstacle.py and tests/test_torch_obstacle_3d*.py;
the global-backend tests (tests/test_torch_obstacle_global*.py) hold their
cases ("2dg", "3dg", "grid2d") against tests/goldens/e2e_global.npz, the
variants' (tests/torch_variants_golden.py: "b2nd", "pcdg", "jacoff", "p1")
against tests/goldens/e2e_variants.npz."""
import pathlib

import numpy as np
import pytest
import torch

from admm_optim_tpu.models import obstacle as jobstacle
from admm_optim_tpu.optim import admm as jadmm
from admm_optim_tpu.solvers import ns_solver as jns
from admm_optim_tpu_torch import convert
from admm_optim_tpu_torch.models.obstacle import ObstacleShapeOpt
from admm_optim_tpu_torch.ops.deformation import barycenter
from admm_optim_tpu_torch.ops.geometry import elem_geometry

GOLD = np.load(pathlib.Path(__file__).parent / "goldens" / "e2e_steps.npz")
GLOBAL_GOLD = np.load(pathlib.Path(__file__).parent / "goldens" / "e2e_global.npz")
VARIANTS_GOLD = np.load(pathlib.Path(__file__).parent / "goldens" / "e2e_variants.npz")
VARIANTS = ("b2nd", "pcdg", "jacoff", "p1")
# tests/test_e2e_2d.py:20-28 and tests/test_e2e_3d.py:22-33, as in make_e2e_goldens.py
CONFIGS = {
    "2d": dict(dim=2, num_refs=1, visc=0.05, sigma_threshold=0.3,
               admm=dict(admm_steps=40, ns_max_its=8, tau=2.0, lin_max_iters=120)),
    "3d": dict(dim=3, num_refs=0, visc=0.1, sigma_threshold=0.3,
               admm=dict(admm_steps=60, ns_max_its=10, tau=2.0, lin_max_iters=400),
               ns=dict(lin_max_iters=1200, lin_restart=100)),
}
# x-update Krylov counts, per step and per lane: exact in 2D; in 3D the
# per-lane counts of the long BiCGStab runs move with the last bits (step
# 1 of a run from the cold start: 652 against the JAX package's 664 in one
# lane, 3,650 against 3,663 in all; on the global backend lanes by up to
# 3.1% over two steps, 645 -> 625)
KRYLOV_REL = {"2d": 0.0, "3d": 0.03, "2dg": 0.0, "3dg": 0.05, "grid2d": 0.0,
              "b2nd": 0.0, "pcdg": 0.0, "jacoff": 0.0, "p1": 0.0}


def jax_config(case, **kw):
    c = dict(CONFIGS[case], **kw)
    a, n = c.pop("admm", {}), c.pop("ns", {})
    return jobstacle.ProblemConfig(**c, admm=jadmm.ADMMConfig(**a), ns=jns.NewtonConfig(**n))


def port(case, **kw):
    return ObstacleShapeOpt(convert.problem_config(jax_config(case, **kw)), device="cpu", dtype=torch.float64)


def golden(case, key):
    gold = GOLD if case in CONFIGS else VARIANTS_GOLD if case in VARIANTS else GLOBAL_GOLD
    return gold[f"{case}_{key}"]


def obstacle_golden(case, prob, hist, steps, drag_rel=1e-8, krylov_rel=None):
    """Hold the records of hist, the port's steps `steps`, against the
    golden's (module docstring); drag_diff, a difference of two drags, to
    twice drag_rel; the Krylov counts to krylov_rel (default
    KRYLOV_REL[case])."""
    assert [r.step for r in hist] == list(steps)
    drag = golden(case, "drag")
    for r in hist:
        i = r.step
        assert r.attempts == int(golden(case, "attempts")[i])
        assert (r.sigma, r.scaling) == (float(golden(case, "sigma")[i]), float(golden(case, "scaling")[i]))
        assert (r.admm_iters, r.newton_iters) == (int(golden(case, "admm_iters")[i]), int(golden(case, "newton_iters")[i]))
        tol = KRYLOV_REL[case] if krylov_rel is None else krylov_rel
        gs = golden(case, "solver_iters")[i].tolist()
        assert abs(r.lin_iters - int(golden(case, "lin_iters")[i])) <= tol * int(golden(case, "lin_iters")[i])
        assert len(r.solver_iters) == len(gs)
        assert all(abs(a - b) <= tol * b for a, b in zip(r.solver_iters, gs)), (r.solver_iters, gs)
        assert abs(r.drag - float(drag[i])) <= drag_rel * abs(float(drag[i]))
        assert abs(r.drag_diff - float(golden(case, "drag_diff")[i])) <= 2 * drag_rel * abs(float(drag[i]))
        log = prob.step_log[[entry["step"] for entry in prob.step_log].index(i)]
        assert len(log["ns"]) == int(golden(case, "ns_solves")[i]) and all(n["converged"] for n in log["ns"])
        assert log["adjoint"]["exit"] == "target"
        assert [a["outcome"] for a in log["attempts"]][-1] == "accepted"


def mesh_invariants(prob, X):
    """The JAX package's e2e invariants (tests/test_e2e_2d.py) on the mesh X."""
    E = prob.elems
    assert X.is_contiguous()
    assert float(elem_geometry(X, E)[3].sum()) == pytest.approx(float(prob.ref_volume), rel=1e-6)
    np.testing.assert_allclose(barycenter(X, E, torch.zeros_like(X.T)).numpy(), prob.ref_barycenter.numpy(), atol=1e-5)
    assert prob._min_det(X) > 0
    assert float(torch.linalg.vector_norm((X - prob.X0) * prob.obstacle_vmask[:, None])) > 1e-3
