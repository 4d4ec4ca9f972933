"""The optimization step of the port on the global (block-ELL) backend
against the JAX package's, float64 on the CPU, at 2D refs=1 on the channel
with alternating diagonals (no brick metadata; tests/torch_global_golden.py,
goldens in tests/goldens/e2e_global.npz): two steps from the cold start,
step 1 resumed from the JAX package's state after step 0, and one step on
a .ugx file of that channel written into tmp_path by the port's
core/ugx.write_ugx (grid_path).  tests/torch_obstacle_golden.py says what
is held: attempts, sigma, scaling, ADMM and Newton counts, the x-update's
Krylov counts, drags to 1e-8.  No hand-written kernel is launched on this
path, and backend "auto" on a mesh without brick metadata selects it."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_global_golden as G
from admm_optim_tpu_torch import convert
from admm_optim_tpu_torch.core import geomgen, ugx
from admm_optim_tpu_torch.models.obstacle import ObstacleShapeOpt, ProblemConfig
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.optim.admm import ADMMConfig
from test_torch_admm_global import global_problem
from torch_obstacle_golden import golden, mesh_invariants, obstacle_golden

torch.set_num_threads(1)

WRAPPERS = ("apply_w_sym", "apply_w_full", "apply_w_full_t", "apply_w_pencil", "apply_w_pencil_batched",
            "apply_w_df_sym")


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of every kernel wrapper."""
    calls = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    for name in WRAPPERS:
        monkeypatch.setattr(sk, name, spy(name, getattr(sk, name)))
    return calls


def test_two_steps_2d_global_match_jax(kernel_calls):
    prob = global_problem("2dg")
    assert not prob.use_patch and prob.hier.levels[0].bricks is None
    hist = prob.run(num_steps=2)
    assert [r.nu for r in prob.ladder.rungs] == [0.16, 0.08, 0.05]
    assert abs(prob.drag_init - float(golden("2dg", "drag_init"))) <= 1e-8 * float(golden("2dg", "drag_init"))
    obstacle_golden("2dg", prob, hist, range(2))
    assert [log["adjoint"]["iters"] for log in prob.step_log] == golden("2dg", "adjoint_iters").tolist()
    mesh_invariants(prob, prob.X_final)
    np.testing.assert_allclose(prob.X_final.numpy(), golden("2dg", "X_final"), rtol=0, atol=1e-8)
    assert kernel_calls == {}


def test_resumed_step1_2d_global_matches_jax():
    """A resume carries no warm start: the cold adjoint's lambda lands
    elsewhere within its target and the re-solve has no recycle space, so
    the drag is held to 1e-7 (as tests/test_torch_obstacle.py holds the
    patch backend's resumed step) and the x-update's Krylov counts to 1%
    (measured: one lane 121 against the uninterrupted run's 120)."""
    prob = global_problem("2dg")
    after0 = {k: golden("2dg", f"after0_{k}") for k in ("X", "s", "sigma", "step", "drag_old")}
    resume = convert.resume_state(dict(after0, drag_init=golden("2dg", "drag_init")), "cpu")
    hist = prob.run(num_steps=2, resume=resume)
    assert prob.ladder is None
    obstacle_golden("2dg", prob, hist, [1], drag_rel=1e-7, krylov_rel=0.01)
    mesh_invariants(prob, prob.X_final)


def test_grid_path_step_matches_jax(tmp_path):
    """The .ugx file of the coarse channel, refined once; backend "auto"
    takes the global backend (a grid carries no brick metadata)."""
    path = tmp_path / G.GRID_NAME
    G.write_channel_ugx(path, ugx, geomgen)
    c = dict(G.GRID_CONFIG)
    a = c.pop("admm")
    prob = ObstacleShapeOpt(ProblemConfig(**c, grid_path=str(path), admm=ADMMConfig(**a)), device="cpu",
                            dtype=torch.float64)
    assert prob.cfg.backend == "auto" and not prob.use_patch and prob.hier.fine.num_vertices == 296
    hist = prob.run(num_steps=1)
    obstacle_golden("grid2d", prob, hist, [0])
    mesh_invariants(prob, prob.X_final)


def test_patch_backend_on_a_mesh_without_bricks_is_refused():
    with pytest.raises(ValueError, match="brick metadata"):
        ObstacleShapeOpt(dataclasses.replace(global_problem("2dg").cfg, backend="patch"),
                         hier=global_problem("2dg").hier, device="cpu")
