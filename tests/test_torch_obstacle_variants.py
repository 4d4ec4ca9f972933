"""The optimization step of the port without an assembled NS Jacobian,
float64 on the CPU at 2D refs=1, visc 0.16, against the JAX package's
(tests/goldens/e2e_variants.npz; tests/torch_variants_golden.py): with
ns_assembled_jac "off" (the matrix-free jvp / vjp and the residual's B^T,
"jacoff") and with P1/P1 velocity, vorder 1 and stab 0.05 ("p1"), both on
the patch backend.  What is held: tests/torch_obstacle_golden.py, and the
adjoint's count."""
import pytest
import torch

import torch_variants_golden as V
from admm_optim_tpu.models import obstacle as jobstacle
from admm_optim_tpu.optim import admm as jadmm
from admm_optim_tpu_torch import convert
from admm_optim_tpu_torch.models.obstacle import ObstacleShapeOpt
from torch_obstacle_golden import golden, mesh_invariants, obstacle_golden

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["jacoff", "p1"])
def test_step_without_an_assembled_jacobian_matches_jax(case):
    kw = dict(V.CONFIGS[case])
    a = kw.pop("admm")
    prob = ObstacleShapeOpt(convert.problem_config(jobstacle.ProblemConfig(**kw, admm=jadmm.ADMMConfig(**a))),
                            device="cpu", dtype=torch.float64)
    assert prob.use_patch and not prob.ns.assembled and prob.ns.space.vorder == kw.get("vorder", 2)
    hist = prob.run(num_steps=1)
    assert prob.ladder.rungs[0].newton.converged
    obstacle_golden(case, prob, hist, [0])
    assert [log["adjoint"]["iters"] for log in prob.step_log] == golden(case, "adjoint_iters").tolist()
    mesh_invariants(prob, prob.X_final)
