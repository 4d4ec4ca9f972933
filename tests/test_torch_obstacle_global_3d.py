"""The first optimization step of the port on the global (block-ELL) backend at
3D refs=0 (the settings of tests/test_e2e_3d.py with backend="global")
against the JAX package's, float64 on the CPU (goldens in
tests/goldens/e2e_global.npz; tests/torch_obstacle_golden.py says what is
held; in 3D the x-update's long BiCGStab runs move their Krylov counts
with the last bits: measured on this path, the sums within 1% and single
lanes by up to 3.1% over two steps, hence 5%).  The 3D channel carries brick metadata, so
only backend="global" takes this path."""
import torch

from test_torch_admm_global import global_problem
from torch_obstacle_golden import golden, mesh_invariants, obstacle_golden

torch.set_num_threads(1)


def test_step_3d_global_matches_jax():
    prob = global_problem("3dg")
    assert not prob.use_patch and prob.hier.levels[0].bricks is not None
    hist = prob.run(num_steps=1)
    obstacle_golden("3dg", prob, hist, [0])
    assert prob.step_log[0]["adjoint"]["iters"] == int(golden("3dg", "adjoint_iters")[0])
    mesh_invariants(prob, prob.X_final)
