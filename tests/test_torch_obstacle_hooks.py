"""The output hooks of models/obstacle.py at work, float64 on the CPU at
2D refs=1 with the settings of tests/test_torch_obstacle.py: one step from
the golden's ladder state (no ladder runs) with every output switched on
(newton_output, debug_output, debug_nodal_positions, debug_nans, and
run's telemetry, checkpoint_path and profiler), and one attempt that the
descent test rejects (catalog_failures).  Each case checks what its flag
or argument writes or does."""
import json

import numpy as np
import pytest
import torch

from admm_optim_tpu_torch.core.ugx import read_ugx
from admm_optim_tpu_torch.io.checkpoint import load_checkpoint
from admm_optim_tpu_torch.io.telemetry import TelemetryWriter
from admm_optim_tpu_torch.utils import debug
from admm_optim_tpu_torch.utils.profiling import Profiler
from torch_obstacle_golden import golden, obstacle_golden, port

torch.set_num_threads(1)

PHASES = ["adjoint", "jprime", "assemble", "admm", "min_det", "ns_solve", "drag"]
RESTORED_FAILURE = {"step": -1, "drag": 0.95, "diff": 0.01, "sigma": 0.6}


def ladder_resume(prob, **kw):
    """The golden's state after the ladder, as a "step -1" checkpoint."""
    return dict(X=prob.X0, s=torch.as_tensor(golden("2d", "ladder_s")), sigma=prob.cfg.sigma_threshold, step=-1,
                drag_old=float(golden("2d", "drag_init")), **kw)


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    out = tmp_path_factory.mktemp("hooks")
    checked = []
    check = debug.check_finite

    def spy(phase, **arrays):
        checked.append((phase, sorted(arrays)))
        check(phase, **arrays)

    mp = pytest.MonkeyPatch()
    mp.setattr(debug, "check_finite", spy)
    try:
        prob = port("2d", newton_output=True, debug_output=True, debug_nodal_positions=True, debug_nans=True)
        tele, prof = TelemetryWriter(str(out)), Profiler()
        hist = prob.run(num_steps=1, telemetry=tele, checkpoint_path=str(out / "checkpoint.npz"), profiler=prof,
                        resume=ladder_resume(prob, failures_json=json.dumps([RESTORED_FAILURE])))
        tele.close()
    finally:
        mp.undo()
    # resumed without the ladder's recycle space, the re-solve stops
    # elsewhere within its tolerance (test_resumed_step_2d_matches_jax)
    obstacle_golden("2d", prob, hist, [0], drag_rel=1e-7)
    return out, prob, hist, prof, checked


def rows(path):
    return [line.split("\t") for line in path.read_text().strip().splitlines()]


def test_newton_output_writes_the_newton_files(full):
    out, prob, hist, _, _ = full
    stats, its = rows(out / "__NewtonStats_step_0_.txt"), rows(out / "__NewtonIterations_step_0_.txt")
    assert len(stats) == len(its) >= 1
    assert [r[0] for r in stats] == [str(i + 1) for i in range(len(stats))]
    assert all(len(r) == 5 and r[1] == "0.0" for r in stats)
    # step, rhs, B_vol, B_x, B_y and the eliminated large solve
    assert all(len(r) == 6 and r[-1] == "0" and all(v.isdigit() for v in r) for r in its)
    assert sum(int(r[1]) for r in its) <= hist[0].solver_iters[0]


def test_debug_output_writes_the_mesh_and_the_newton_fields(full):
    out, prob, _, _, _ = full
    g = read_ugx(str(out / "Mesh_lev1_step0.ugx"))  # the mesh the step started from
    np.testing.assert_array_equal(g.coords[:, :2], prob.X0.numpy())
    V = prob.X0.shape[0]
    for name in ("ConsistentLu_step_0", "RHSBigProb_0", "delta_u_step_0"):
        text = (out / f"{name}.vtu").read_text()
        assert f'NumberOfPoints="{V}"' in text and "tensor(" not in text


def test_debug_nodal_positions_writes_the_deformed_mesh(full):
    out, prob, _, _, _ = full
    text = (out / "grid_positions_step_0.vtu").read_text()
    assert 'Name="u" NumberOfComponents="3"' in text
    assert repr(float(prob.X_final[1, 0])) in text


def test_debug_nans_checks_each_phase_boundary(full):
    _, _, _, _, checked = full
    assert [p for p, _ in checked] == ["adjoint", "jprime", "assemble", "admm", "ns_solve"]
    assert checked[0][1] == ["lam_adj"] and checked[3][1] == ["lam", "u"] and len(checked[2][1]) > 5


def test_telemetry_writes_the_reference_files(full):
    out, prob, hist, _, _ = full
    r = hist[0]
    drag = rows(out / "__Drag.txt")
    assert drag == [["0", repr(r.drag), repr(r.drag / prob.drag_init), repr(r.drag_diff),
                     repr(r.shape_derivative / (r.scaling * r.sigma))]]
    assert rows(out / "__Iterations_per_step.txt") == [
        [str(v) for v in (0, r.admm_iters, r.sigma, r.newton_iters, r.lin_iters, *r.solver_iters, 0)]]
    stats = np.array(rows(out / "__ADMMStats_step_0_.txt"), float)
    assert stats.shape == (r.admm_iters, 6) and np.all(stats[:, 1] == r.sigma)
    assert json.loads((out / "history.jsonl").read_text())["drag"] == r.drag
    # the restored catalogue, written beside the accepted step
    assert rows(out / "__Failure_Data.txt") == [["0", "-1", "0.95", "0.01", "0.6"]]
    for f in out.iterdir():
        if f.suffix in (".txt", ".vtu", ".jsonl"):
            assert "tensor(" not in f.read_text(), f.name


def test_checkpoint_path_writes_the_checkpoint_and_sidecar(full):
    out, prob, hist, _, _ = full
    ck = load_checkpoint(str(out / "checkpoint.npz"))
    assert ck["step"] == 0 and ck["drag_old"] == hist[0].drag and ck["sigma"] == hist[0].sigma
    assert ck["drag_init"] == float(golden("2d", "drag_init"))
    np.testing.assert_array_equal(ck["X"], prob.X_final.numpy())
    assert json.loads(ck["failures_json"]) == [RESTORED_FAILURE]
    assert [h["step"] for h in json.loads(ck["history_json"])] == [0]
    with np.load(out / "checkpoint.npz.warm.npz") as z:
        assert sorted(z.files) == ["adj_U", "lam_adj", "ns_U"]


def test_profiler_gets_the_step_phases(full):
    _, prob, _, prof, _ = full
    assert sorted(prof.totals) == sorted(PHASES)
    seconds = prob.step_log[0]["seconds"]
    assert list(seconds) == PHASES
    assert all(prof.totals[k] == pytest.approx(v, rel=1e-12) for k, v in seconds.items())
    assert prof.counts["admm"] == len(prob.step_log[0]["attempts"])
    assert all(k in prof.report() for k in PHASES)


@pytest.mark.parametrize("catalog", [True, False])
def test_catalog_failures_writes_the_rejected_field(tmp_path, catalog):
    """A descent test no step passes (line_search_param 1e3): the attempt
    is rejected, and its u lands in failed_flows_step_0_failure_0.vtu when
    the catalogue is kept."""
    prob = port("2d", line_search_param=1e3, max_attempts_per_step=1)
    tele = TelemetryWriter(str(tmp_path))
    hist = prob.run(num_steps=1, telemetry=tele, catalog_failures=catalog, resume=ladder_resume(prob))
    tele.close()
    assert hist == [] and prob.step_log[0]["attempts"][0]["outcome"] == "not a descent"
    vtu = tmp_path / "failed_flows_step_0_failure_0.vtu"
    assert vtu.exists() == catalog
    if catalog:
        assert 'Name="u_fail"' in vtu.read_text()
