"""The port's spans in the ADMM inner loop (optim.admm), on the CPU at 3D
refs=0 in float64 with the r4-admm cell's loop settings (5 ADMM
iterations, up to 10 Newton steps each): their names and counts per ADMM
iteration and per Newton step, a host.sync span around every blocking read
of the Newton and ADMM loops, the z-prox's ``projected`` attribute, the
same loop traced and untraced, and no record without a profiler."""
import collections
import dataclasses

import pytest
import torch

from admm_optim_tpu_torch import admm_run, xupdate_solve
from admm_optim_tpu_torch.ops import patchdeform
from admm_optim_tpu_torch.optim.spaces import PatchOps
from admm_optim_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = dataclasses.replace(admm_run.BENCH_CFG, ns_max_its=10)
# the direct children of admm.newton, a Newton step: the constraint
# gradients, the Hessian assembly, the lane solve, the lane counts, the
# flags, the Schur update, then |DLambda|, |Lu|, |g| and |du| (and the
# exchanges of the operator and constraint applies between them)
STEP = ["admm.cgrads", "admm.hess", "admm.lanes", "host.sync", "host.sync", "admm.schur", "host.sync", "host.sync",
        "host.sync", "host.sync"]


@pytest.fixture(scope="module")
def ctx():
    return xupdate_solve.build(0, "cpu", torch.float64)


@pytest.fixture(scope="module")
def traced(ctx):
    """The same loop untraced and under a CPU profiler, and the records."""
    Jp = admm_run.shape_gradient(ctx, seed=3)
    off = admm_run.run(ctx, CFG, Jp=Jp)
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = admm_run.run(ctx, CFG, Jp=Jp)
    recs = profiling.spans()
    profiling.reset_spans()
    return off.state, on.state, recs


def _children(recs, i):
    return [j for j, r in enumerate(recs) if r["parent"] == i]


def test_names_and_counts(traced):
    _, s, recs = traced
    n = collections.Counter(r["name"] for r in recs)
    assert (s.admm_it, s.newton_failed) == (5, False) and s.total_newton > s.admm_it
    assert n["admm.inner"] == 1
    for name in ("admm.iter", "admm.z_prox", "admm.newton", "admm.dual"):
        assert n[name] == s.admm_it, name
    for name in ("admm.cgrads", "admm.hess", "admm.lanes", "admm.schur"):
        assert n[name] == s.total_newton, name
    loop = next(i for i, r in enumerate(recs) if r["name"] == "admm.inner")
    iters = _children(recs, loop)
    assert [recs[i]["name"] for i in iters] == ["admm.iter"] * s.admm_it
    steps = []
    for i in iters:
        kids = _children(recs, i)
        assert [recs[j]["name"] for j in kids] == ["admm.z_prox", "host.sync", "admm.newton", "admm.dual",
                                                  "host.sync", "host.sync"]
        newton = kids[2]
        steps.append(sum(1 for j in _children(recs, newton) if recs[j]["name"] == "admm.hess"))
    assert sum(steps) == s.total_newton and min(steps) >= 1


def test_host_sync_around_each_newton_read(traced):
    """Every Newton step's reads are host.sync spans in the step's order,
    and each lane solve's CG reads its active-lane count once an iteration
    of its longest lane and once more at the end."""
    _, s, recs = traced
    lanes = []
    for i, r in enumerate(recs):
        if r["name"] != "admm.newton":
            continue
        kids = [recs[j]["name"] for j in _children(recs, i) if recs[j]["name"] != "st.exchange"]
        assert kids == STEP * (len(kids) // len(STEP)) and len(kids) % len(STEP) == 0
        lanes += [j for j in _children(recs, i) if recs[j]["name"] == "admm.lanes"]
    reads = [sum(1 for k in _children(recs, j) if recs[k]["name"] == "host.sync") for j in lanes]
    assert len(lanes) == s.total_newton and sum(reads) == s.batch_iters + s.total_newton


def test_cgrads_span_says_plain(traced):
    """Every admm.cgrads span of the traced CPU loop carries path "plain":
    the constraint gradients of a CPU field take the plain form."""
    _, s, recs = traced
    assert [r["attrs"]["path"] for r in recs if r["name"] == "admm.cgrads"] == ["plain"] * s.total_newton


def test_z_prox_counts_the_cells_it_moved(traced):
    _, _, recs = traced
    moved = [r["attrs"]["projected"] for r in recs if r["name"] == "admm.z_prox"]
    # from u = 0 and lambda = 0 the first prox has nothing to move; J' x 0.01
    # keeps every |grad u + lambda / tau| under sigma = 0.3 here
    assert moved == [0] * 5


def test_z_prox_projected_under_a_small_sigma(ctx):
    """With sigma far below |grad u| the second prox moves cells, at most
    every cell of the lattice."""
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        admm_run.run(ctx, dataclasses.replace(CFG, admm_steps=2, sigma_threshold=1e-4), seed=3)
    moved = [r["attrs"]["projected"] for r in profiling.spans() if r["name"] == "admm.z_prox"]
    profiling.reset_spans()
    cells = len(ctx.ps.class_offsets) * ctx.ps.fine.m ** 3 * ctx.ps.P
    assert moved[0] == 0 and 0 < moved[1] <= cells


def test_same_loop_traced(traced):
    off, on, _ = traced
    for f in ("u", "lam", "q_proj", "Lambda"):
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    assert (off.total_newton, off.total_lin_iters, off.batch_iters) == (on.total_newton, on.total_lin_iters,
                                                                      on.batch_iters)


class _NoClock:
    def time_ns(self):
        raise AssertionError("a span read the clock with no profiler recording")


def test_no_records_without_a_profiler(ctx, monkeypatch):
    """No profiler: the loop appends no record, never enters
    record_function, never reads a span's clock, and makes no read for the
    projected attribute."""
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "time", _NoClock())
    profiling.reset_spans()
    out = admm_run.run(ctx, dataclasses.replace(CFG, admm_steps=2), seed=4)
    assert out.state.admm_it == 2 and profiling.spans() == []
    assert profiling.span("admm.z_prox") is profiling.span("admm.inner")


def test_geometry_once_and_one_constraint_pass_a_newton_step(ctx, monkeypatch):
    """One run derives its bundle's cell geometry once, and evaluates the
    constraints once per Newton step and once per x-update: a step's
    values of the updated iterate serve the next step's Schur update."""
    calls = collections.Counter()

    def spy(name, f):
        def wrapped(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return wrapped

    monkeypatch.setattr(patchdeform, "cell_geometry", spy("geometry", patchdeform.cell_geometry))
    monkeypatch.setattr(PatchOps, "constraints", spy("constraints", PatchOps.constraints))
    xupdates = []
    out = admm_run.run(ctx, CFG, seed=3, iter_cb=lambda k, u, Lambda: xupdates.append(k))
    s = out.state
    assert (s.admm_it, s.newton_failed) == (5, False) and len(xupdates) == s.admm_it
    assert calls["geometry"] == 1
    assert calls["constraints"] == s.total_newton + len(xupdates)
