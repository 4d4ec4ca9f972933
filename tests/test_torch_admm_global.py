"""The port's ADMM inner loop on the global representation
(optim/admm.py admm_inner_global over optim/spaces.py GlobalOps) against
the JAX package's admm_inner on its global backend, float64, at the
undeformed 2D refs=1 channel with alternating diagonals and the 3D refs=0
channel, with tests/torch_global_golden.py's synthetic J' (goldens in
tests/goldens/e2e_global.npz, made by tests/goldens/make_e2e_goldens.py
global).  ADMM and Newton counts and flags equal, u, Lambda and the dual
tensor to 1e-8 of their largest entry.  The x-update's Krylov counts move
with the last bits, because the vertex and assembly sums add in another
order than XLA's segment sums: in 2D (40 ADMM iterations, ~4,000 BiCGStab
iterations) the sum is held to 0.1% and each lane to one iteration in a
thousand (measured: 3,978 against the JAX package's 3,979 in index_add
order, 3,979 in the GPU's fixed order); in 3D the sum to 3% (as
tests/torch_obstacle_golden.py holds it) and each lane to 8% (the
constraint lanes: 280, 202, 211 in index_add order and 279, 204, 212 in
the fixed order, against 291, 218, 212, with u equal to 1.8e-12).  The GlobalOps operators themselves are
held to 1e-12 in tests/test_torch_global_ops.py."""
import pathlib

import numpy as np
import pytest
import torch

import torch_global_golden as G
from admm_optim_tpu_torch import xupdate_solve
from admm_optim_tpu_torch.models.obstacle import ObstacleShapeOpt, ProblemConfig
from admm_optim_tpu_torch.optim.admm import ADMMConfig, admm_inner_global

torch.set_num_threads(1)

GOLD = np.load(pathlib.Path(__file__).parent / "goldens" / "e2e_global.npz")
KRYLOV_REL = {"2dg": 0.001, "3dg": 0.03}
LANE_REL = {"2dg": 0.001, "3dg": 0.08}


def global_problem(case):
    c = dict(G.CONFIGS[case])
    a = c.pop("admm")
    c.pop("ns", None)
    return ObstacleShapeOpt(ProblemConfig(**c, admm=ADMMConfig(**a)), device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("case", ["2dg", "3dg"])
def test_admm_inner_global_equals_the_jax_package(case):
    prob = global_problem(case)
    assert not prob.use_patch and prob.xu.space is not None
    X = prob.X0
    Jp = torch.as_tensor(GOLD[f"admm_{case}_Jp"])
    np.testing.assert_allclose(Jp.numpy(), G.jp_of(X.numpy(), prob.obstacle_vmask.numpy()), rtol=0, atol=1e-15)
    st = admm_inner_global(prob.cfg.admm, prob.xu.struct, xupdate_solve.assemble(prob.xu, X), X, prob.elems,
                           prob.ns.free_def, Jp, G.ADMM_SIGMA, G.ADMM_SCALING, prob.ref_volume, prob.ref_barycenter,
                           vplan=prob.xu.vplan)

    def gold(k):
        return GOLD[f"admm_{case}_{k}"]

    assert (st.admm_it, st.total_newton) == (int(gold("admm_it")), int(gold("total_newton")))
    assert (st.converged, st.failed) == (bool(gold("converged")), bool(gold("failed")))
    assert st.scaling == float(gold("scaling"))
    tol = KRYLOV_REL[case]
    assert abs(st.total_lin_iters - int(gold("total_lin_iters"))) <= tol * int(gold("total_lin_iters"))
    lane = LANE_REL[case]
    assert all(abs(a - b) <= lane * b for a, b in zip(st.solver_iters, gold("solver_iters").tolist()))
    for name, got in (("u", st.u), ("Lambda", st.Lambda), ("lam", st.lam)):
        want = gold(name)
        assert np.abs(got.numpy() - want).max() <= 1e-8 * np.abs(want).max(), name
