"""The r2-ns-newton cell's yardstick on the CPU: the span readers on
synthetic records, the counter and roofline readers, the limits file's
readings on either side of each limit, and the check against the planted
faults and the control at refs=0 (a few minutes on one core)."""
import sys
import time
import types

import pytest

from benchmark import cost_ns, harness, spans_ns
from benchmark.drivers.ns_resolve import CONTROL, FAULTS

CARD = "NVIDIA H100 80GB HBM3"
CONFIG = harness.load_json(harness.ROOT / "configs" / "channel3d-r2-ns.json")
LIMITS = harness.load_json(harness.ROOT / "limits" / "r2-ns-newton.json")


def _rec(name, parent, ms=0.0, **attrs):
    return dict(name=name, parent=parent, start_ns=0, end_ns=int(ms * 1e6), request=0, attrs=attrs)


RECS = [
    _rec("host.sync", None, 1.0),  # outside any re-solve
    _rec("ns.newton", None, 500.0, visc=0.02),
    _rec("host.sync", 1, 0.5),
    _rec("ns.iterate", 1, 400.0),
    _rec("ns.assemble", 3, 20.0, part="velocity"),
    _rec("host.sync", 4, 0.25),
    _rec("ns.assemble", 3, 30.0, part="jacobian"),
    _rec("ns.krylov", 3, 300.0),
    _rec("ns.precond", 7, 2.0),
    _rec("host.sync", 7, 0.5),
    _rec("ns.line_search", 3, 40.0),
    _rec("ns.newton", None, 600.0, visc=0.02),
    _rec("ns.precond", 11, 4.0),
    _rec("ns.newton", 11, 1.0),  # a re-solve inside a re-solve counts once
    _rec("host.sync", 13, 0.25),
]


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setitem(sys.modules, spans_ns.PROFILING, types.SimpleNamespace(spans=lambda: list(RECS)))


def _run(kind=CARD):
    return harness.Run(config=CONFIG, traffic={}, cell={}, seed=0, device_kind=kind)


def test_span_readers_on_synthetic_records(program):
    recs, roots = spans_ns.under_roots(RECS)
    assert roots == 2 and len(recs) == 12
    run = _run()
    assert harness.load_reader("ns_host_syncs_per_solve").read(run) == 2.0
    assert harness.load_reader("ns_assembly_ms_per_solve").read(run) == 25.0
    assert harness.load_reader("ns_precond_ms_per_solve").read(run) == 3.0
    assert harness.load_reader("ns_line_search_ms_per_solve").read(run) == 20.0


def test_span_readers_read_nothing_off_the_card_or_without_a_re_solve(program, monkeypatch):
    assert harness.load_reader("ns_host_syncs_per_solve").read(_run("cpu")) is None
    monkeypatch.setitem(sys.modules, spans_ns.PROFILING, types.SimpleNamespace(spans=lambda: RECS[:1]))
    assert harness.load_reader("ns_precond_ms_per_solve").read(_run()) is None
    # a program whose re-solves hold no such span (the parent's) reads None
    bare = [_rec("ns.newton", None, 600.0), _rec("ns.precond", 0, 4.0)]
    monkeypatch.setitem(sys.modules, spans_ns.PROFILING, types.SimpleNamespace(spans=lambda: bare))
    assert harness.load_reader("ns_line_search_ms_per_solve").read(_run()) is None
    monkeypatch.delitem(sys.modules, spans_ns.PROFILING)
    assert harness.load_reader("ns_assembly_ms_per_solve").read(_run()) is None


def test_counter_and_roofline_readers():
    run = _run()
    run.requests = [dict(newton=4, lin_iters=500, drag=0.5), dict(newton=5, lin_iters=600, drag=0.5)]
    assert harness.load_reader("ns_newton_iters_per_solve").read(run) == 4.5
    assert harness.load_reader("ns_lin_iters_per_solve").read(run) == 550.0
    roof = harness.load_reader("stencil_roofline.ns")
    assert roof.read(run) is None  # no trace
    run.trace = types.SimpleNamespace(busy_s=2.0, window_s=20.0)
    run.peaks = {"hbm_bytes_per_s": 3.35e12}
    run.traced_requests = run.requests[:1]
    want = 100.0 * cost_ns.request_bytes(CONFIG, 4, 500) / 3.35e12 / 2.0
    assert roof.read(run) == pytest.approx(want, rel=1e-12)
    assert harness.load_reader("device_idle_pct.ns").read(run) == 90.0


@pytest.mark.parametrize("number", sorted(LIMITS["limits"]))
def test_limits_between_the_readings(number):
    """lower (the program's worst) < limit < upper (the least reading of
    the control and faults the number catches), and each of those reads
    above the limit."""
    r, limit = LIMITS["readings"][number], LIMITS["limits"][number]
    assert r["lower"] < limit < r["upper"]
    assert r["caught_by"] and all(r[v] > limit for v in r["caught_by"])
    assert r["upper"] == min(r[v] for v in r["caught_by"])


def test_the_control_is_caught():
    caught = {v for r in LIMITS["readings"].values() for v in r["caught_by"]}
    assert CONTROL in caught and caught <= {CONTROL, *FAULTS}


R0 = harness.load_json(harness.ROOT / "tests" / "data" / "channel3d-r0-ns.json")
TRAFFIC = harness.load_json(harness.ROOT / "traffic" / "ns-resolve.json")
CELL = {"name": "r0-ns", "config": R0["name"], "traffic": "ns-resolve", "chips": 1}
SEED = 2**31 + 8191


def _execute(variant):
    hook = None if variant == "program" else (lambda d: d.plant(variant))
    return harness.execute(CELL, R0, TRAFFIC, LIMITS, [], SEED, 0.0, False, "cpu", time.monotonic(),
                           driver_hook=hook)


def _readings(r):
    return {k: c["value"] for k, c in r["checks"].items() if k != "failed"}


@pytest.fixture(scope="module")
def program_run():
    return _execute("program")


@pytest.mark.parametrize("variant", (CONTROL, "state_unchanged", "mesh_stale"))
def test_the_check_catches_the_control_and_faults(variant, program_run):
    """The bf16 control, the unsolved state and the stale mesh read at
    least 30 times the program's reading in one of the check's numbers at
    refs=0, and fail the card's limits.  one_iterate is left out here: at
    refs=0 and visc 0.16 one Newton iterate from the ladder's state comes
    within 3x of the converged residual."""
    r = _execute(variant)
    prog = _readings(program_run)
    assert any(v >= 30.0 * prog[k] for k, v in _readings(r).items()), (_readings(r), prog)
    assert not r["correct"]
