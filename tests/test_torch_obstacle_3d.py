"""Step 0 of the port's optimization loop at 3D refs=0 (the settings of
tests/test_e2e_3d.py) against the JAX package's, float64 on the CPU.  The
port resumes from the JAX package's "step -1" state, the state its ladder
reached at visc 0.1 (through convert.resume_state), so that the file keeps
to its time; tests/test_torch_obstacle.py runs the ladder and two steps in
2D, and tests/test_torch_obstacle_3d_step1.py takes step 1 from the JAX
package's state after step 0.  What is held: tests/torch_obstacle_golden.py's
obstacle_golden (the x-update Krylov counts within 3%, because the
per-lane counts of the long 3D BiCGStab runs move with the last bits), the
adjoint's count and the mesh invariants of the JAX package's e2e tests."""
import torch

from admm_optim_tpu_torch import convert
from torch_obstacle_golden import golden, mesh_invariants, obstacle_golden, port

torch.set_num_threads(1)


def test_step0_3d_matches_jax():
    prob = port("3d")
    drag_init = float(golden("3d", "drag_init"))
    resume = convert.resume_state(
        dict(X=prob.X0.numpy(), s=golden("3d", "ladder_s"),
             sigma=golden("3d", "sigma")[0], step=-1, drag_old=drag_init), "cpu")
    hist = prob.run(num_steps=1, resume=resume)
    assert abs(prob._drag(prob.X0, resume["s"]) - drag_init) <= 1e-12 * drag_init
    obstacle_golden("3d", prob, hist, [0])
    assert prob.step_log[0]["adjoint"]["iters"] == int(golden("3d", "adjoint_iters")[0])
    mesh_invariants(prob, prob.X_final)
    dX = float((prob.X_final - prob.X0).abs().max())
    assert float((prob.X_final - convert.tensor(golden("3d", "after0_X"), "cpu")).abs().max()) <= 1e-6 * dX
