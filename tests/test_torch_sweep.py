"""The port's design sweeps (models/sweep.py) against the JAX package's,
float64, on the 2D refs=1 global-backend problem of
tests/torch_global_golden.py (goldens in tests/goldens/e2e_global.npz):
sigma_sweep over two sigmas, geometry_sweep over the undeformed mesh and
one deformed by half the first candidate's u, and best_candidate's drags
from the ladder's state.  Each candidate equals its single admm_inner call
bit for bit (as tests/test_sweep.py holds the JAX sweep's lanes to theirs),
and the JAX sweep's ADMM and Newton counts, flags and u (to 1e-8), its
Krylov counts to KRYLOV_REL (tests/test_torch_admm_global.py says why);
best_candidate's index, and its drags to BEST_DRAG_REL.  geometry_sweep
also on tests/test_sweep.py's 2D refs=1 backend="auto" problem, whose
x-update runs on the patch backend (golden tests/goldens/e2e_sweep_patch.npz):
the sweep runs on the global space of the same mesh, as the JAX package's
on its def_space."""
import pathlib

import numpy as np
import pytest
import torch

import torch_global_golden as G
from admm_optim_tpu_torch import xupdate_solve
from admm_optim_tpu_torch.models import sweep
from admm_optim_tpu_torch.models.obstacle import ObstacleShapeOpt, ProblemConfig
from admm_optim_tpu_torch.optim.admm import ADMMConfig, admm_inner_global
from test_torch_admm_global import global_problem

torch.set_num_threads(1)

GOLD = np.load(pathlib.Path(__file__).parent / "goldens" / "e2e_global.npz")
PATCH_GOLD = np.load(pathlib.Path(__file__).parent / "goldens" / "e2e_sweep_patch.npz")
# the re-solves stop at the float64 stall exit, |R| ~6e-10, whose state
# moves with the last bits of u: the JAX package's own u gives the drag to
# 6e-11, the port's (1e-12 from it) to 3.7e-8 (measured)
BEST_DRAG_REL = 1e-7
COUNTERS = ("admm_it", "total_newton", "total_lin_iters", "converged", "failed", "scaling")
KRYLOV_REL = 0.001


@pytest.fixture(scope="module")
def prob():
    return global_problem("2dg")


def _jax_equal(states, name, gold=GOLD):
    for k in COUNTERS:
        if k != "total_lin_iters":
            np.testing.assert_array_equal(getattr(states, k).numpy(), gold[f"{name}_{k}"], err_msg=k)
    for k in ("total_lin_iters", "solver_iters"):
        want = gold[f"{name}_{k}"]
        assert np.all(np.abs(getattr(states, k).numpy() - want) <= KRYLOV_REL * want), k
    for k in ("u", "Lambda"):
        want = gold[f"{name}_{k}"]
        assert np.abs(getattr(states, k).numpy() - want).max() <= 1e-8 * np.abs(want).max(), k


def _single_equal(states, b, st):
    for k in COUNTERS:
        assert getattr(states, k)[b].item() == getattr(st, k), k
    assert states.solver_iters[b].tolist() == st.solver_iters
    assert torch.equal(states.u[b], st.u) and torch.equal(states.Lambda[b], st.Lambda)


def test_sigma_sweep_and_best_candidate(prob):
    X, Jp = prob.X0, torch.as_tensor(GOLD["admm_2dg_Jp"])
    states = sweep.sigma_sweep(prob, X, Jp, G.SWEEP_SIGMAS)
    assert states.u.shape == (2,) + tuple(Jp.shape)
    _jax_equal(states, "sigma_sweep")
    single = prob._admm(xupdate_solve.assemble(prob.xu, X), X, Jp, G.SWEEP_SIGMAS[0], 1.0)
    _single_equal(states, 0, single)
    idx, drags = sweep.best_candidate(prob, X, torch.as_tensor(GOLD["2dg_ladder_s"]), states)
    assert idx == int(GOLD["best_index"])
    want = GOLD["best_drags"]
    assert np.all(np.isfinite(drags) == np.isfinite(want))
    ok = np.isfinite(want)
    assert np.abs(drags[ok] - want[ok]).max() <= BEST_DRAG_REL * np.abs(want[ok]).max()


def test_geometry_sweep(prob):
    X, Jp = prob.X0, torch.as_tensor(GOLD["admm_2dg_Jp"])
    Xs = torch.stack([X, X + G.GEOMETRY_SHARE * torch.as_tensor(GOLD["sigma_sweep_u"][0]).T])
    states = sweep.geometry_sweep(prob, Xs, Jp.expand((2,) + Jp.shape), sigma=G.GEOMETRY_SIGMA)
    _jax_equal(states, "geometry_sweep")
    X1 = Xs[1].contiguous()
    single = admm_inner_global(prob.cfg.admm, prob.xu.struct, xupdate_solve.assemble(prob.xu, X1), X1, prob.elems,
                               prob.ns.free_def, Jp, G.GEOMETRY_SIGMA, 1.0, prob.ref_volume, prob.ref_barycenter,
                               vplan=prob.xu.vplan)
    _single_equal(states, 1, single)


def test_geometry_sweep_on_a_patch_problem():
    """The repair: on a patch-backend problem geometry_sweep ran into a
    ValueError; now it builds the global deformation context of the same
    hierarchy once (kept on the problem) and gives the JAX package's
    geometry_sweep, which runs on def_space whatever the backend."""
    c = dict(G.PATCH_SWEEP_CONFIG)
    a = c.pop("admm")
    prob = ObstacleShapeOpt(ProblemConfig(**c, admm=ADMMConfig(**a)), device="cpu", dtype=torch.float64)
    assert prob.use_patch and prob.xu.space is None
    Xs = torch.as_tensor(G.perturbed_meshes(prob.X0.numpy(), prob.ns.free_def.numpy(), G.PATCH_SWEEP_LANES))
    np.testing.assert_array_equal(Xs.numpy(), PATCH_GOLD["Xs"])
    Jp = torch.as_tensor(PATCH_GOLD["Jp"])
    states = sweep.geometry_sweep(prob, Xs, Jp.expand((len(Xs),) + Jp.shape), sigma=G.PATCH_SWEEP_SIGMA)
    _jax_equal(states, "geometry_sweep_patch", PATCH_GOLD)
    xu = sweep.global_xupdate(prob)
    assert xu is prob._xu_global and xu.space is not None and xu.coeffs == (1.0, 2.0, 1.0)
    X0 = Xs[0].contiguous()
    single = admm_inner_global(prob.cfg.admm, xu.struct, xupdate_solve.assemble(xu, X0), X0, prob.elems,
                               prob.ns.free_def, Jp, G.PATCH_SWEEP_SIGMA, 1.0, prob.ref_volume, prob.ref_barycenter,
                               vplan=xu.vplan)
    _single_equal(states, 0, single)
