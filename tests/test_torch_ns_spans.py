"""The port's spans on the NS forward Newton path (ns_run.newton,
solvers/ns_solver.py, the FGMRES loops of solvers/krylov.py), on the CPU
at 3D refs=0 in float64, with short solves (one Newton iterate, chunks
of 10 Arnoldi steps, 20 an iterate, a recycle space of 2) so that every branch
the r2-ns-newton cell takes runs in seconds: their tree and counts, a
host.sync span around every blocking read and synchronization, the same
solve traced and untraced, and no record without a profiler."""
import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from admm_optim_tpu_torch import ns_run
from admm_optim_tpu_torch.utils import profiling

torch.set_num_threads(1)

READS = ("__float__", "__int__", "__bool__", "item", "numpy", "tolist")


@pytest.fixture(scope="module")
def ctx():
    ctx = ns_run.build(0, "cpu", torch.float64, visc=0.16)
    cfg = dataclasses.replace(ctx.cfg, max_iters=1, lin_restart=30, lin_exec_chunk=10, lin_max_iters=20,
                              lin_recycle_k=2)
    return dataclasses.replace(ctx, cfg=cfg)


@contextlib.contextmanager
def blocking_reads(monkeypatch):
    """Every blocking read of a tensor, every copy of a host array to a
    device (which waits for the device's queue) and ns_run's
    synchronizations: for each, the innermost open host.sync record, or
    None outside one, and whether it ran inside ns.newton."""
    seen = []

    def where():
        open_ = [i for i in profiling._open if profiling._records[i]["name"] == "host.sync"]
        inside = any(profiling._records[i]["name"] == "ns.newton" for i in profiling._open)
        return (open_[-1] if open_ else None), inside

    def wrap(fn):
        def read(*args, **kwargs):
            seen.append(where())
            return fn(*args, **kwargs)
        return read

    def upload(fn):
        def as_tensor(data, *args, **kwargs):
            if isinstance(data, np.ndarray) and kwargs.get("device") is not None:
                seen.append(where())
            return fn(data, *args, **kwargs)
        return as_tensor

    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, wrap(getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "as_tensor", upload(torch.as_tensor))
    monkeypatch.setattr(ns_run, "_sync", wrap(ns_run._sync))
    yield seen


@pytest.fixture(scope="module")
def traced(ctx):
    """A cold start, then the re-solve from its state with its recycle
    space, untraced and under a CPU profiler; the records and reads of
    the traced re-solve, and the records of the untraced one."""
    first, _ = ns_run.newton(ctx, recycle=(rec := {}))
    assert rec["U"].shape[0] == 2
    profiling.reset_spans()
    off, _ = ns_run.newton(ctx, first.s, recycle={"U": rec["U"]}, X=ctx.coords * 1.01)
    untraced = profiling.spans()
    mp = pytest.MonkeyPatch()
    profiling.reset_spans()
    try:
        with blocking_reads(mp) as seen, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            on, _ = ns_run.newton(ctx, first.s, recycle={"U": rec["U"]}, X=ctx.coords * 1.01)
    finally:
        mp.undo()
    recs = profiling.spans()
    profiling.reset_spans()
    return off, on, recs, seen, untraced


def _children(recs, i):
    return [j for j, r in enumerate(recs) if r["parent"] == i]


def test_tree_and_counts(traced):
    _, res, recs, _, _ = traced
    n = collections.Counter(r["name"] for r in recs)
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["ns.newton"]
    assert roots[0]["attrs"] == {"visc": 0.16, "iters": res.iters, "lin_iters": sum(res.lin_iters)}
    assert res.iters == 1 and res.lin_iters == [22]
    for name in ("ns.iterate", "ns.krylov", "ns.line_search"):
        assert n[name] == res.iters, name
    # each iterate: the velocity V-cycle data, the Jacobian, the linear
    # solve, the line search
    for i, r in enumerate(recs):
        if r["name"] == "ns.iterate":
            kids = [recs[j] for j in _children(recs, i)]
            assert [k["name"] for k in kids] == ["ns.assemble", "ns.assemble", "ns.krylov", "ns.line_search"]
            assert [k["attrs"] for k in kids[:2]] == [{"part": "velocity"}, {"part": "jacobian"}]
    # a preconditioner apply an Arnoldi step: 20 a solve, the recycle
    # space's 2 re-imaging applies are plain
    assert n["ns.precond"] == sum(res.lin_iters) - 2 * res.iters


def test_every_blocking_read_is_a_host_sync(traced):
    """Inside ns.newton every blocking read, upload and synchronization
    happens in a host.sync span, and each host.sync span holds one: the
    first |R|, per iterate the two clocks of each assembly part, per FGMRES
    cycle its norm, a Hessenberg block a chunk and one at its end with the
    upload of its solution, the recycle selection's blocks and the two
    uploads of its coefficients, and the line search's |R|."""
    _, res, recs, seen, _ = traced
    inside = [span for span, under in seen if under]
    assert inside and None not in inside
    syncs = {i for i, r in enumerate(recs) if r["name"] == "host.sync"}
    assert set(inside) == syncs
    # one cycle of two chunks an iterate: 1 + iters * (4 + 1 + 2 + 2 + 3 + 1)
    assert len(syncs) == 1 + res.iters * 13


def test_traced_and_untraced_agree(traced):
    off, on, _, _, _ = traced
    assert torch.equal(off.s, on.s) and off.lin_iters == on.lin_iters and off.res_history == on.res_history


def test_nothing_recorded_without_a_profiler(traced):
    assert traced[4] == []
