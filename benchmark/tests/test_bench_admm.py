"""The r4-admm cell's yardstick on the CPU: cost_admm's byte counts against
a count by hand, the span readers on synthetic records, and the limits
file's readings on either side of each limit."""
import copy
import sys
import types

import pytest

from benchmark import cost, cost_admm, harness, spans_admm

CARD = "NVIDIA H100 80GB HBM3"
CONFIG = harness.load_json(harness.ROOT / "configs" / "channel3d-r4-admm.json")
LIMITS = harness.load_json(harness.ROOT / "limits" / "r4-admm.json")


def _at_refs(refs):
    cfg = copy.deepcopy(CONFIG)
    cfg["mesh"]["refs"] = refs
    return cfg


def test_cost_at_refs1():
    """At refs=1 the fine lattice is 3^3 x 224 (below the pencil stream's
    edge of 9) over the 360-vertex base: a Newton step whose lanes took
    at most 4 iterations runs 4 + 1 batched applies of H and V-cycles over
    5 lanes and one apply of A."""
    cfg = _at_refs(1)
    n = 3 * 27 * 224  # unknowns of one field on the fine lattice
    w_sym = 8 * 9 * 27 * 224 * 4  # the float32 half stencil
    h_lanes = w_sym + 5 * 2 * n * 4  # W once, x and y of 5 lanes
    vcycle = 4 * h_lanes + 1080 * 1080 * 4 + 5 * 2 * 1080 * 4  # 4 applies on level 1, the dense base
    a_once = w_sym + 2 * n * 4
    assert cost_admm.lanes(cfg) == 5
    assert cost_admm.lane_apply_bytes(cfg, 1, "f32_sym", 5) == h_lanes
    assert cost_admm.lane_vcycle_bytes(cfg, 5) == vcycle
    assert cost_admm.loop_bytes(cfg, 1, 4) == 5 * (h_lanes + vcycle) + a_once
    assert cost_admm.loop_bytes(cfg, 2, 5) == 7 * (h_lanes + vcycle) + 2 * a_once


def test_cost_at_refs4_streams_the_pencil_levels():
    """At refs=4 levels 3 and 4 (edges 9 and 17) smooth on the bf16 pencil
    stream (15 slots), levels 1 and 2 on the float32 half stencil."""
    cfg = CONFIG

    def lanes_apply(edge, w_slots, w_bytes):
        s = edge ** 3 * 224
        return w_slots * 9 * s * w_bytes + 5 * 2 * 3 * s * 4

    vcycle = 4 * (lanes_apply(3, 8, 4) + lanes_apply(5, 8, 4) + lanes_apply(9, 15, 2) + lanes_apply(17, 15, 2))
    vcycle += 1080 * 1080 * 4 + 5 * 2 * 1080 * 4
    assert cost_admm.lane_vcycle_bytes(cfg, 5) == vcycle
    assert cost_admm.lane_apply_bytes(cfg, 4, "f32_sym", 1) == cost.apply_bytes(cfg, 4, "f32_sym")


def _rec(name, parent, ms=0.0):
    return dict(name=name, parent=parent, start_ns=0, end_ns=int(ms * 1e6), request=0, attrs={})


RECS = [
    _rec("host.sync", None, 1.0),  # admm_run's clock, outside any loop
    _rec("admm.inner", None, 50.0),
    _rec("admm.iter", 1, 40.0),
    _rec("host.sync", 2, 0.5),
    _rec("admm.hess", 2, 2.0),
    _rec("host.sync", None, 1.0),
    _rec("admm.inner", None, 60.0),
    _rec("admm.hess", 6, 4.0),
    _rec("host.sync", 7, 0.25),
    _rec("admm.inner", 6, 1.0),  # a loop inside a loop counts once
    _rec("host.sync", 9, 0.25),
]


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setitem(sys.modules, spans_admm.PROFILING, types.SimpleNamespace(spans=lambda: list(RECS)))


def _run(kind=CARD):
    return harness.Run(config=CONFIG, traffic={}, cell={}, seed=0, device_kind=kind)


def test_span_readers_on_synthetic_records(program):
    recs, loops = spans_admm.under_loops(RECS)
    assert loops == 2 and len(recs) == 7 and all(r["name"] != "admm.inner" or r["parent"] == 6 for r in recs)
    run = _run()
    assert spans_admm.count_per_loop(run, ("host.sync",)) == 1.5
    assert spans_admm.ms_per_loop(run, ("admm.hess",)) == 3.0
    assert harness.load_reader("admm_host_syncs_per_loop").read(run) == 1.5
    assert harness.load_reader("admm_hess_ms_per_loop").read(run) == 3.0


def test_span_readers_read_nothing_off_the_card_or_without_a_loop(program, monkeypatch):
    assert spans_admm.count_per_loop(_run("cpu"), ("host.sync",)) is None
    monkeypatch.setitem(sys.modules, spans_admm.PROFILING, types.SimpleNamespace(spans=lambda: RECS[:1]))
    assert spans_admm.ms_per_loop(_run(), ("admm.hess",)) is None
    monkeypatch.delitem(sys.modules, spans_admm.PROFILING)
    assert harness.load_reader("admm_host_syncs_per_loop").read(_run()) is None


def test_counter_and_roofline_readers():
    run = _run()
    run.requests = [dict(newton=17, lin_iters=600, batch_iters=150), dict(newton=18, lin_iters=640)]
    assert harness.load_reader("newton_iters_per_loop").read(run) == 17.5
    assert harness.load_reader("lane_cg_iters_per_loop").read(run) == 620.0
    roof = harness.load_reader("stencil_roofline.admm")
    assert roof.read(run) is None  # no trace
    run.trace = types.SimpleNamespace(busy_s=0.5, window_s=1.0)
    run.peaks = {"hbm_bytes_per_s": 3.35e12}
    run.traced_requests = run.requests[:1]
    want = 100.0 * cost_admm.loop_bytes(CONFIG, 17, 150) / 3.35e12 / 0.5
    assert roof.read(run) == pytest.approx(want, rel=1e-12)
    assert harness.load_reader("device_idle_pct.admm").read(run) == 50.0


@pytest.mark.parametrize("number", sorted(LIMITS["limits"]))
def test_limits_between_the_readings(number):
    """lower (the program's worst) < limit < upper (the least reading of
    the control and faults the number catches), and each of those reads
    above the limit."""
    r, limit = LIMITS["readings"][number], LIMITS["limits"][number]
    assert r["lower"] < limit < r["upper"]
    assert r["caught_by"] and all(r[v] > limit for v in r["caught_by"])
    assert r["upper"] == min(r[v] for v in r["caught_by"])


def test_every_variant_is_caught():
    caught = {v for r in LIMITS["readings"].values() for v in r["caught_by"]}
    assert caught == {"bf16", "state_unchanged", "answer_altered", "dlambda_zero"}
