"""The optimization step of the port (models/obstacle.py) against the JAX
package's ObstacleShapeOpt on the patch backend, float64 on the CPU: two
steps at 2D refs=1 with the settings of tests/test_e2e_2d.py, from the cold
start, and a step resumed from the JAX package's state after step 0.  The
JAX runs (marked slow there) are goldens made by
tests/goldens/make_e2e_goldens.py with the JAX package's host-stepped
drivers, whose chunk-unit counts the port reproduces; the 3D refs=0 steps
are in tests/test_torch_obstacle_3d*.py.  What is held and why:
tests/torch_obstacle_golden.py.

Also: the configuration and resume state converters, the float32 presets,
and the settings that ROADMAP item 9b brought (b2nd_order, vorder=1, the
matrix-free NS operators, PCD on the global backend), each run through one
attempt at 2D refs=0 (their parity with the JAX package is held in
tests/test_torch_b2nd_order.py, _obstacle_variants.py, _pcd_global.py and
_ns_matfree.py).
ObstacleShapeOpt's outputs, checkpoints and profiler are held in
tests/test_torch_obstacle_hooks.py and tests/test_torch_resume.py."""
import dataclasses

import numpy as np
import pytest
import torch

from admm_optim_tpu.models import obstacle as jobstacle
from admm_optim_tpu.optim import admm as jadmm
from admm_optim_tpu.solvers import ns_solver as jns
from admm_optim_tpu_torch import convert
from admm_optim_tpu_torch.models import obstacle
from admm_optim_tpu_torch.models.obstacle import ObstacleShapeOpt, ProblemConfig
from admm_optim_tpu_torch.optim.admm import ADMMConfig
from torch_obstacle_golden import golden, mesh_invariants, obstacle_golden, port

torch.set_num_threads(1)


def test_two_steps_2d_match_jax():
    """Cold start (the ladder 0.16 -> 0.08 -> 0.05), then two steps with
    the adjoint warm from the last step's lambda and recycle space and the
    forward recycle space carried across rungs and steps."""
    prob = port("2d")
    hist = prob.run(num_steps=2)
    assert prob.ladder is not None and [r.nu for r in prob.ladder.rungs] == [0.16, 0.08, 0.05]
    assert abs(prob.drag_init - float(golden("2d", "drag_init"))) <= 1e-8 * float(golden("2d", "drag_init"))
    obstacle_golden("2d", prob, hist, range(2))
    assert [entry["adjoint"]["iters"] for entry in prob.step_log] == golden("2d", "adjoint_iters").tolist()
    assert prob._cur_lam_adj is not None and prob._adj_recycle["U"].shape[0] == prob.cfg.ns.adj_recycle_k
    assert prob._ns_recycle.get("U") is not None
    assert abs(float(prob.ref_volume) - float(golden("2d", "ref_volume"))) <= 1e-12 * float(golden("2d", "ref_volume"))
    np.testing.assert_allclose(prob.ref_barycenter.numpy(), golden("2d", "ref_barycenter"), atol=1e-12)
    mesh_invariants(prob, prob.X_final)
    dX = np.abs(golden("2d", "X_final") - golden("2d", "after0_X")).max()
    assert np.abs(prob.X_final.numpy() - golden("2d", "X_final")).max() <= 1e-6 * dX
    # per phase seconds and launches (none on CPU tensors)
    phases = {"adjoint", "jprime", "assemble", "admm", "min_det", "ns_solve", "drag"}
    assert all(set(entry["seconds"]) == phases for entry in prob.step_log)
    assert not any(n for entry in prob.step_log for n in entry["launches"].values())


def test_resumed_step_2d_matches_jax():
    """Step 1 from the JAX package's state after step 0, through
    convert.resume_state, gives the golden's step 1.  A resume carries no
    warm start: the adjoint starts cold (its count is not held), and the
    re-solve has no recycle space, so its Krylov path differs from the JAX
    run's and it stops elsewhere within the Newton tolerance (|R| <= ~5e-9
    on both): the drag to 1e-7."""
    prob = port("2d")
    after0 = {k: golden("2d", f"after0_{k}") for k in ("X", "s", "sigma", "step", "drag_old")}
    resume = convert.resume_state(dict(after0, drag_init=golden("2d", "drag_init")), "cpu")
    assert resume["X"].is_contiguous() and resume["step"] == 0
    iterates, accepted = [], []
    hist = prob.run(num_steps=2, resume=resume, callback=lambda *a: accepted.append(a),
                    admm_iter_cb=lambda *a: iterates.append(a))
    assert prob.ladder is None and prob.drag_init == float(golden("2d", "drag_init"))
    obstacle_golden("2d", prob, hist, [1], drag_rel=1e-7)
    mesh_invariants(prob, prob.X_final)
    # callback(step, X, s, rec) once per accepted step; admm_iter_cb(step,
    # attempt, k, u) with every ADMM iterate's global u (d, V), k counting
    # on across the loop's restarts, the last u the step's
    assert [(a[0], a[3]) for a in accepted] == [(1, hist[0])] and accepted[0][1] is prob.X_final
    assert [a[:3] for a in iterates] == [(1, 1, k) for k in range(len(iterates))]
    assert len(iterates) >= hist[0].admm_iters
    u = iterates[-1][3]
    assert u.shape == prob.X0.T.shape
    assert float((prob.X_final - resume["X"] - u.T).abs().max()) <= 1e-12


def test_problem_config_converts_field_by_field():
    cfg = jobstacle.ProblemConfig(
        dim=3, num_refs=1, num_steps=7, visc=0.05, stab=0.1, sigma_threshold=0.2, scaling=2.0,
        line_search_param=1e-4, do_nothing=False, diameter=5.0, max_attempts_per_step=5,
        pressure_precond="pcd", vel_inner=2, ns_jac_mem_cap=1e9, admm_failure_control="sigma",
        admm=jadmm.ADMMConfig(tau=2.0, x_solver="cg", lambda_init=(0.1, 0.2)),
        ns=jns.NewtonConfig(lin_max_iters=77, adj_recycle_k=4),
    )
    got = convert.problem_config(cfg)
    names = [f.name for f in dataclasses.fields(jobstacle.ProblemConfig)]
    assert [f.name for f in dataclasses.fields(ProblemConfig)] == names
    for name in names:
        if name in ("admm", "ns"):
            assert dataclasses.asdict(getattr(got, name)) == dataclasses.asdict(getattr(cfg, name)), name
        else:
            assert getattr(got, name) == getattr(cfg, name), name
    assert convert.problem_config(jobstacle.ProblemConfig()) == ProblemConfig()


@pytest.mark.parametrize("dim", [2, 3])
def test_f32_presets_equal_the_jax_package(dim):
    cfg = jobstacle.ProblemConfig(dim=dim, admm=jadmm.ADMMConfig(ns_tol=1e-2))
    assert obstacle.f32_presets(convert.problem_config(cfg)) == convert.problem_config(jobstacle.f32_presets(cfg))


def _one_attempt(**kw):
    """One optimization step's first attempt at 2D refs=0, visc 0.16, with
    a small x-update budget: what the setting runs, not its parity."""
    cfg = ProblemConfig(num_refs=0, visc=0.16, max_attempts_per_step=1,
                        admm=ADMMConfig(admm_steps=3, ns_max_its=3, tau=2.0, lin_max_iters=20), **kw)
    prob = ObstacleShapeOpt(cfg, device="cpu", dtype=torch.float64)
    hist = prob.run(num_steps=1)
    assert prob.ladder.rungs[-1].newton.converged and len(hist) <= 1
    log = prob.step_log[0]
    assert log["adjoint"]["exit"] == "target" and len(log["attempts"]) == 1
    return prob


@pytest.mark.parametrize("field,value,item", [
    ("b2nd_order", True, "item 9b"),
    ("vorder", 1, "item 9b"),
    ("ns_assembled_jac", "off", "item 9b"),
])
def test_unported_settings_raise(field, value, item):
    """What ROADMAP item 9b brought runs: the ladder, the adjoint and one
    attempt, on the path the JAX package takes
    (b2nd_order: the x-update on the global backend, the NS side on the
    patch one; vorder=1 and ns_assembled_jac="off": no assembled Jacobian)."""
    assert item == "item 9b"
    prob = _one_attempt(**{field: value})
    assert prob.use_patch_ns and prob.use_patch == (field != "b2nd_order")
    assert prob.ns.assembled == (field == "b2nd_order")
    assert prob.ns.space.vorder == (1 if field == "vorder" else 2)


@pytest.mark.parametrize("kw", [dict(pressure_precond="pcd"), dict(ns_jac_mem_cap=1.0)], ids=["pcd", "mem_cap"])
def test_global_backend_refusals(kw):
    """On the global backend PCD (the ELL forms) and the matrix-free jvp
    above the memory cap run; no fallback to the patch path."""
    prob = _one_attempt(backend="global", **kw)
    assert not prob.use_patch and not prob.use_patch_ns and prob.ns.pre_ps is None
    assert prob.ns.assembled == ("ns_jac_mem_cap" not in kw)
    assert (prob.ns.p_space is not None) == ("pressure_precond" in kw)


def test_jacobian_above_the_memory_cap_raises():
    """Above ns_jac_mem_cap "auto" falls back to the matrix-free jvp, as the
    JAX package does (obstacle.py:369-416); "on" assembles, "off" does not
    even under the cap."""
    ctx = ObstacleShapeOpt(ProblemConfig(num_refs=0, ns_jac_mem_cap=1.0), device="cpu").ns
    assert not ctx.assembled and ctx.jac_bytes > 1.0
    assert ObstacleShapeOpt(ProblemConfig(num_refs=0, ns_jac_mem_cap=1.0, ns_assembled_jac="on"),
                            device="cpu").ns.assembled
    assert not ObstacleShapeOpt(ProblemConfig(num_refs=0, ns_assembled_jac="off"), device="cpu").ns.assembled
    assert ObstacleShapeOpt(ProblemConfig(num_refs=0), device="cpu").ns.assembled


def test_entry_point_defaults_to_the_card():
    """No device named: the card, and without one an error instead of a
    fall back to the CPU; unknown settings are refused."""
    if torch.cuda.is_available():
        assert ObstacleShapeOpt(ProblemConfig(num_refs=0)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ObstacleShapeOpt(ProblemConfig(num_refs=0))
    for field, value in (("backend", "ell"), ("admm_failure_control", "tau"), ("ns_assembled_jac", "yes")):
        with pytest.raises(ValueError, match=field):
            ObstacleShapeOpt(ProblemConfig(num_refs=0, **{field: value}), device="cpu")
    with pytest.raises(ValueError, match="2D"):
        ObstacleShapeOpt(ProblemConfig(dim=3, num_refs=0), hier=obstacle.ns_run.channel(0, 2), device="cpu")
