"""A run of the port killed after step 0 and resumed from its checkpoint
and warm sidecar (models/obstacle.py, io/checkpoint.py) against the JAX
package's uninterrupted run, float64 on the CPU at 2D refs=1 with the
settings of tests/test_torch_obstacle.py:

  * run A takes step 0 from the cold start with a checkpoint path and
    telemetry: the "step -1" checkpoint after the ladder and the step-0
    checkpoint with its sidecar are written;
  * a fresh model resumed from that checkpoint and sidecar takes step 1,
    which equals the golden's uninterrupted step 1 as
    test_two_steps_2d_match_jax holds it, the adjoint's count included
    (the sidecar carries lambda and both recycle spaces; without it the
    adjoint starts cold);
  * so does a fresh model resumed from the checkpoint and sidecar that the
    JAX package wrote after its step 0 (tests/goldens/e2e_ckpt_2d*.npz,
    made by tests/goldens/make_e2e_goldens.py ckpt);
  * __Drag.txt and __Iterations_per_step.txt stay one file over both runs
    and equal the JAX run's."""
import dataclasses
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from admm_optim_tpu_torch.io.checkpoint import load_checkpoint
from admm_optim_tpu_torch.io.telemetry import TelemetryWriter
from admm_optim_tpu_torch.models import obstacle
from torch_obstacle_golden import golden, mesh_invariants, obstacle_golden, port

torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens"
JAX_TELEMETRY = np.load(GOLDENS / "e2e_ckpt_2d_telemetry.npz")
# the drags agree to 1e-8 relative (torch_obstacle_golden.py); the other
# float columns of __Drag.txt (drag / drag_init, the drag decrease and
# <J', u>) are made of two such numbers: 2e-8 of the drag
DRAG_REL = 1e-8


def columns(text):
    return [line.split("\t") for line in str(text).strip().splitlines()]


def assert_drag_file(text, want):
    """__Drag.txt: the step column equal, the drag within DRAG_REL, the
    others within 2 * DRAG_REL of the largest drag."""
    got, exp = np.array(columns(text), float), np.array(columns(want), float)
    assert got.shape == exp.shape
    np.testing.assert_array_equal(got[:, 0], exp[:, 0])
    scale = np.abs(exp[:, 1]).max()
    for j in range(1, exp.shape[1]):
        tol = (1 if j == 1 else 2) * DRAG_REL * scale
        assert np.abs(got[:, j] - exp[:, j]).max() <= tol, (j, got[:, j], exp[:, j])


def assert_iterations_file(text, want):
    """__Iterations_per_step.txt: every column equal (counts and sigma)."""
    assert columns(text) == columns(want)


@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    """Step 0 from the cold start with a checkpoint path and telemetry,
    save_checkpoint spied on."""
    out = tmp_path_factory.mktemp("run")
    ckpt = str(out / "checkpoint.npz")
    saved = []
    orig = obstacle.save_checkpoint

    def spy(path, **kw):
        saved.append(dict(kw, path=path))
        orig(path, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(obstacle, "save_checkpoint", spy)
    try:
        tele = TelemetryWriter(str(out))
        prob = port("2d")
        hist = prob.run(num_steps=1, telemetry=tele, checkpoint_path=ckpt)
        tele.close()
    finally:
        mp.undo()
    return out, ckpt, saved, prob, hist


def resumed_step_1(prob, hist, out):
    """What a step 1 resumed with its sidecar must give: the golden's
    uninterrupted step 1 with its adjoint count, after the restored step 0,
    and the telemetry of the whole run."""
    assert prob.ladder is None and len(prob.step_log) == 1
    assert set(prob.sidecar_restored) == {"lam_adj", "adj_U", "ns_U"}
    n = prob.ns.n_state
    assert prob.sidecar_restored["lam_adj"] == (n,)
    assert prob.sidecar_restored["adj_U"] == (prob.cfg.ns.adj_recycle_k, n)
    assert prob.sidecar_restored["ns_U"] == (prob.cfg.ns.lin_recycle_k, n)
    assert [r.step for r in hist] == [0, 1]
    assert prob.drag_init == pytest.approx(float(golden("2d", "drag_init")), rel=1e-8)
    obstacle_golden("2d", prob, hist[1:], [1])
    assert prob.step_log[0]["adjoint"]["iters"] == int(golden("2d", "adjoint_iters")[1])
    assert int(JAX_TELEMETRY["adjoint_iters"][1]) == int(golden("2d", "adjoint_iters")[1])
    mesh_invariants(prob, prob.X_final)
    assert_drag_file((out / "__Drag.txt").read_text(), JAX_TELEMETRY["drag"])
    assert_iterations_file((out / "__Iterations_per_step.txt").read_text(), JAX_TELEMETRY["iterations"])
    ck = load_checkpoint(str(out / "checkpoint.npz"))
    assert ck["step"] == 1 and len(json.loads(ck["history_json"])) == 2
    np.testing.assert_array_equal(ck["X"], prob.X_final.numpy())


def test_cold_start_checkpoints_the_ladder_and_step_0(run_a):
    out, ckpt, saved, prob, hist = run_a
    assert [(s["path"], s["step"]) for s in saved] == [(ckpt, -1), (ckpt, 0)]
    ladder = saved[0]
    np.testing.assert_array_equal(ladder["X"], prob.X0.numpy())
    assert ladder["extra"] == {"drag_init": prob.drag_init, "history_json": "[]", "failures_json": "[]"}
    assert ladder["drag_old"] == prob.drag_init and ladder["sigma"] == prob.cfg.sigma_threshold
    obstacle_golden("2d", prob, hist, [0])
    ck = load_checkpoint(ckpt)
    assert ck["step"] == 0 and ck["drag_init"] == prob.drag_init and ck["drag_old"] == hist[0].drag
    assert json.loads(ck["history_json"]) == [json.loads(json.dumps(dataclasses.asdict(hist[0])))]
    assert json.loads(ck["failures_json"]) == []
    np.testing.assert_array_equal(ck["s"], prob.s_final.numpy())
    with np.load(ckpt + ".warm.npz") as z:
        assert sorted(z.files) == ["adj_U", "lam_adj", "ns_U"]
        np.testing.assert_array_equal(z["lam_adj"], prob._cur_lam_adj.numpy())
        np.testing.assert_array_equal(z["adj_U"], prob._adj_recycle["U"].numpy())
        np.testing.assert_array_equal(z["ns_U"], prob._ns_recycle["U"].numpy())
    assert len((out / "__Drag.txt").read_text().splitlines()) == 1


def test_step_resumed_from_the_ports_checkpoint_matches_jax(run_a):
    out, ckpt, _, _, hist_a = run_a
    tele = TelemetryWriter(str(out))
    prob = port("2d")
    hist = prob.run(num_steps=2, telemetry=tele, checkpoint_path=ckpt, resume=load_checkpoint(ckpt))
    tele.close()
    assert hist[0] == dataclasses.replace(hist_a[0], solver_iters=tuple(hist_a[0].solver_iters))
    resumed_step_1(prob, hist, out)
    assert len((out / "history.jsonl").read_text().splitlines()) == 2


def test_step_resumed_from_the_jax_checkpoint_matches_jax(tmp_path):
    """The checkpoint and sidecar the JAX package wrote after its step 0
    load in the port as they are (the sidecar is kept under another name
    in the repository and copied to <checkpoint>.warm.npz here)."""
    ckpt = tmp_path / "checkpoint.npz"
    shutil.copyfile(GOLDENS / "e2e_ckpt_2d.npz", ckpt)
    shutil.copyfile(GOLDENS / "e2e_ckpt_2d_sidecar.npz", str(ckpt) + ".warm.npz")
    tele = TelemetryWriter(str(tmp_path))
    prob = port("2d")
    hist = prob.run(num_steps=2, telemetry=tele, checkpoint_path=str(ckpt), resume=load_checkpoint(str(ckpt)))
    tele.close()
    resumed_step_1(prob, hist, tmp_path)
