"""The port's utils/ and io/resume.py against the JAX package's:
check_finite names the phase and the array (and a NaN put into J' of a 2D
refs=1 step with debug_nans surfaces as phase 'jprime'), the Profiler keeps
the same keys and prints the same report on the same clock, device_trace
writes a trace on the CPU, and resumable_run retries through a fault and
re-raises after max_restarts."""
import json

import numpy as np
import pytest
import torch

from admm_optim_tpu.io import resume as jresume
from admm_optim_tpu.utils import profiling as jprofiling
from admm_optim_tpu_torch import ns_run
from admm_optim_tpu_torch.io import resume
from admm_optim_tpu_torch.utils import debug, profiling
from torch_obstacle_golden import golden, port

torch.set_num_threads(1)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_check_finite_names_the_phase_and_array(bad):
    ok = torch.ones(3, dtype=torch.float64)
    debug.check_finite("assemble", a=ok, b=None)
    x = ok.clone()
    x[1] = bad
    with pytest.raises(debug.NonFiniteError, match="phase 'admm'.*array 'lam'") as e:
        debug.check_finite("admm", u=ok, lam=x, s=x)
    assert (e.value.phase, e.value.name) == ("admm", "lam")


def test_enable_nan_debug_turns_on_anomaly_detection():
    was = torch.is_anomaly_enabled()
    try:
        debug.enable_nan_debug()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_nan_in_jprime_raises_naming_the_phase(monkeypatch):
    """A 2D refs=1 step from the golden's ladder state (no ladder runs) with
    debug_nans: the NaN put into J' stops the step at the jprime boundary."""
    prob = port("2d", debug_nans=True)
    jprime = ns_run.jprime

    def bad_jprime(*a, **kw):
        Jp = jprime(*a, **kw).clone()
        Jp[0, 0] = float("nan")
        return Jp

    monkeypatch.setattr(ns_run, "jprime", bad_jprime)
    s = torch.as_tensor(golden("2d", "ladder_s"))
    resume_ = dict(X=prob.X0, s=s, sigma=prob.cfg.sigma_threshold, step=-1,
                   drag_old=float(golden("2d", "drag_init")))
    with pytest.raises(debug.NonFiniteError) as e:
        prob.run(num_steps=1, resume=resume_)
    assert (e.value.phase, e.value.name) == ("jprime", "Jp")
    assert prob.ladder is None and list(prob.step_log[0]["seconds"]) == ["adjoint", "jprime"]


class _Clock:
    """perf_counter stand-in: 0.25 s more on every read."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


def _drive(prof):
    with prof.phase("adjoint"):
        pass
    for _ in range(3):
        with prof.phase("admm"):
            with prof.phase("assemble"):
                pass
    with prof.phase("ns_solve", sync=None):
        pass


def test_profiler_keys_and_report_equal_the_jax_package(monkeypatch):
    monkeypatch.setattr(profiling, "time", _Clock())
    monkeypatch.setattr(jprofiling, "time", _Clock())
    got, want = profiling.Profiler(), jprofiling.Profiler()
    _drive(got)
    _drive(want)
    assert dict(got.totals) == dict(want.totals) and dict(got.counts) == dict(want.counts)
    assert sorted(got.totals) == ["adjoint", "admm", "admm/assemble", "ns_solve"]
    assert got.report() == want.report()
    assert got.last == 0.25  # the last phase's seconds, which ObstacleShapeOpt's step log reads
    for null in (profiling.NULL, profiling.Profiler(enabled=False)):
        _drive(null)
        assert not null.totals and null.report() == jprofiling.NULL.report() == "(no phases recorded)"


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace"), "cpu"):
        torch.ones(64, 64, dtype=torch.float64).matmul(torch.ones(64, 64, dtype=torch.float64)).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


class _Model:
    """A stub ObstacleShapeOpt whose run fails on the attempts listed."""

    def __init__(self, calls, fail):
        self.calls, self.fail, self.device = calls, fail, torch.device("cpu")

    def run(self, resume=None, checkpoint_path=None, **kw):
        self.calls.append(resume)
        if len(self.calls) in self.fail:
            raise RuntimeError(f"device fault {len(self.calls)}")
        return ["history", kw]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_resumable_run_retries_through_a_fault(tmp_path, package):
    """A fault before the first checkpoint restarts from scratch, one after
    it from the checkpoint; both packages behave alike."""
    rr = {"port": resume.resumable_run, "jax": jresume.resumable_run}[package]
    ckpt = tmp_path / "checkpoint.npz"
    calls = []

    def build():
        if len(calls) == 1:  # the second attempt finds a checkpoint
            np.savez(ckpt, step=3, X=np.zeros((2, 2)), s=np.zeros(4), sigma=0.3, drag_old=0.5)
        return _Model(calls, fail={1, 2})

    out = rr(build, str(ckpt), max_restarts=2, restart_delay_s=0.0, verbose=False)
    assert out == ["history", {"verbose": False}]
    assert calls[0] is None and calls[1] is None and calls[2]["step"] == 3


def test_resumable_run_reraises_after_max_restarts(tmp_path):
    calls = []
    with pytest.raises(RuntimeError, match="device fault 3"):
        resume.resumable_run(lambda: _Model(calls, fail={1, 2, 3}), str(tmp_path / "ck.npz"), max_restarts=2,
                             restart_delay_s=0.0)
    assert len(calls) == 3
