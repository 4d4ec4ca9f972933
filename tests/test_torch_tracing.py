"""The port's spans (utils.profiling.span) on the solve path, on the CPU at
3D refs=1 in float64: off without a profiler (no record, no
record_function, no clock), and under a torch.profiler profile the names,
the nesting and the counts that follow from the code, the records on the
exported Chrome trace's clock, and the same answer bit for bit.  Also the
ADMM phases and Profiler.phase, which open the same spans."""
import collections
import json

import pytest
import torch

from admm_optim_tpu_torch import admm_run, xupdate_solve
from admm_optim_tpu_torch.solvers import patch_mg
from admm_optim_tpu_torch.utils import profiling

torch.set_num_threads(1)

# name -> the names its parent may have (None: a root)
PARENTS = {
    "xupdate.solve": {None},
    "ir.round": {"xupdate.solve"},
    "ir.residual": {"ir.round"},
    "st.exchange_df": {"ir.residual"},
    "cg.iter": {"ir.round"},
    "mg.vcycle": {"ir.round", "cg.iter"},
    "mg.smooth": {"mg.vcycle"},
    "mg.transfer": {"mg.vcycle"},
    "mg.base": {"mg.vcycle"},
    "st.exchange": {"ir.round", "cg.iter", "mg.smooth", "mg.transfer"},
    "host.sync": {"xupdate.solve", "ir.round"},
}


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def ctx():
    return xupdate_solve.build(1, "cpu", torch.float64)


@pytest.fixture(scope="module")
def traced(ctx, tmp_path_factory):
    """One solve untraced, then the same solve under a CPU profiler: both
    results, the records, and the exported Chrome trace."""
    b = xupdate_solve.random_rhs(ctx, seed=0)
    off = xupdate_solve.solve(ctx, b)
    profiling.reset_spans()
    with _profile() as prof:
        on = xupdate_solve.solve(ctx, b)
    recs = profiling.spans()
    profiling.reset_spans()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    return dict(off=off, on=on, recs=recs, trace=json.loads(path.read_text()))


class _NoClock:
    def time_ns(self):
        raise AssertionError("a span read the clock with no profiler recording")


def test_off_records_nothing(ctx, monkeypatch):
    """No profiler: a cg_ir_p solve appends no record, never enters
    record_function and never reads the clock; every span is one shared
    null context."""
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "time", _NoClock())
    profiling.reset_spans()
    b = xupdate_solve.random_rhs(ctx, seed=1)
    res = patch_mg.cg_ir_p(ctx.struct, ctx.data, b, **xupdate_solve.SOLVE_SETTINGS)
    assert res.converged and profiling.spans() == []
    assert profiling.span("mg.vcycle") is profiling.span("st.exchange", level=3)


def test_on_names_and_nesting(traced):
    recs = traced["recs"]
    assert recs[0]["name"] == "xupdate.solve" and recs[0]["parent"] is None
    for i, r in enumerate(recs):
        assert r["name"] in PARENTS, r["name"]
        parent = None if r["parent"] is None else recs[r["parent"]]
        assert (None if parent is None else parent["name"]) in PARENTS[r["name"]], (i, r["name"])
        assert r["request"] == 0 and r["start_ns"] <= r["end_ns"]
        if parent is not None:
            assert r["parent"] < i and parent["start_ns"] <= r["start_ns"] and r["end_ns"] <= parent["end_ns"]
    levels = {r["attrs"]["level"] for r in recs if r["name"] in ("mg.smooth", "mg.transfer")}
    assert levels == {1}


def test_on_counts_follow_the_solve(traced, ctx):
    """At Chebyshev V(2,2) from zero on k levels above the base: each cycle
    smooths twice and transfers down and up on each level, and exchanges
    4 times a level (one pre-smoothing apply, two post-smoothing, the
    coarse residual) plus once for CG's operator apply."""
    res, k = traced["on"], ctx.ps.k
    n = collections.Counter(r["name"] for r in traced["recs"])
    its, rounds = res.inner_iters, res.rounds
    cycles = its + rounds  # one M(r) a CG iteration and one at each round's start
    assert (its, rounds) == (13, 2)
    assert n["xupdate.solve"] == 1 and n["ir.round"] == rounds and n["cg.iter"] == its
    assert n["ir.residual"] == n["st.exchange_df"] == rounds
    assert n["host.sync"] == its + 3 * rounds + 2
    assert n["mg.vcycle"] == n["mg.base"] == cycles
    assert n["mg.smooth"] == n["mg.transfer"] == 2 * k * cycles
    assert n["st.exchange"] == cycles * (4 * k + 1)
    dirs = collections.Counter(r["attrs"]["dir"] for r in traced["recs"] if r["name"] == "mg.transfer")
    assert dirs == {"restrict": k * cycles, "prolong": k * cycles}


def test_records_on_the_trace_clock(traced):
    """Every record has a user_annotation of its name in the exported trace,
    in the same order.  Its start lies within 1 ms of ts * 1000 +
    baseTimeNanoseconds and its duration within 100 us or 5% of the
    annotation's, the median disagreement within 20 us: record_function's
    own cost under a recording profiler (tens of us on a shared CPU) lies
    between a record's stamps and the annotation's.  A record whose process
    was preempted in between (4-12 ms seen with the test suite's workers on
    the host) misses; 5% of the records may."""
    trace, recs = traced["trace"], traced["recs"]
    base = trace["baseTimeNanoseconds"]
    ann = sorted((e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"), key=lambda e: e["ts"])
    assert [e["name"] for e in ann] == [r["name"] for r in recs]
    diffs, missed = [], []
    for e, r in zip(ann, recs):
        dur = e["dur"] * 1000
        diff = abs((r["end_ns"] - r["start_ns"]) - dur)
        diffs.append(diff)
        if abs(e["ts"] * 1000 + base - r["start_ns"]) > 1e6 or diff > max(1e5, 0.05 * dur):
            missed.append((r["name"], e["ts"] * 1000 + base - r["start_ns"], diff, dur))
    assert len(missed) <= len(recs) // 20, missed
    assert sorted(diffs)[len(diffs) // 2] <= 2e4
    # spans are annotations, never ATen ops
    assert not any(e.get("cat") == "cpu_op" and e["name"] in PARENTS for e in trace["traceEvents"])


def test_same_answer_traced(traced):
    off, on = traced["off"], traced["on"]
    assert torch.equal(off.x_hi, on.x_hi) and torch.equal(off.x_lo, on.x_lo)
    assert (off.rounds, off.inner_iters, off.converged) == (on.rounds, on.inner_iters, on.converged)
    assert torch.equal(off.res_norm, on.res_norm)


def test_admm_phases(ctx):
    """admm_run at bench.py's settings (one ADMM iteration on the refs=1
    context): the iteration is a root with its z-prox, Newton x-update and
    dual update as children, in that order, the x-update's CG under it."""
    profiling.reset_spans()
    with _profile():
        out = admm_run.run(ctx)
    recs = profiling.spans()
    profiling.reset_spans()
    roots = [i for i, r in enumerate(recs) if r["parent"] is None]
    assert [recs[i]["name"] for i in roots] == ["admm.iter"] * out.state.admm_it
    kids = [(i, r["name"]) for i, r in enumerate(recs) if r["parent"] == roots[0]]
    assert [name for _, name in kids] == ["admm.z_prox", "admm.newton", "admm.dual"]
    iters = [r for r in recs if r["name"] == "cg.iter"]
    assert iters and all(r["parent"] == kids[1][0] for r in iters)


def test_profiler_phase_opens_a_span():
    """Profiler.phase is also a span: nested phases nest as records, each
    top-level phase a request of its own, and the timer keeps its keys."""
    prof = profiling.Profiler()
    profiling.reset_spans()
    with _profile():
        with prof.phase("admm"):
            with prof.phase("assemble"):
                torch.ones(4).sum()
        with prof.phase("drag"):
            pass
    recs = profiling.spans()
    profiling.reset_spans()
    assert [(r["name"], r["parent"], r["request"]) for r in recs] == [("admm", None, 0), ("assemble", 0, 0),
                                                                    ("drag", None, 1)]
    assert sorted(prof.totals) == ["admm", "admm/assemble", "drag"]
