"""The readers of the port's spans (benchmark/spans.py and the metrics of
the program_span source) on the records of two CPU solves at refs=1, read
as a run on the card reads them; and nothing read off the card, from a
program without spans, or without a root."""
import sys
import types

import pytest
import torch

from benchmark import harness, spans

CARD = "NVIDIA H100 80GB HBM3"
READERS = ("host_syncs_per_solve", "host_wait_ms_per_solve", "vcycle_host_ms_per_solve",
           "exchange_host_ms_per_solve")


def _run(kind):
    return harness.Run(config={}, traffic={}, cell={}, seed=0, device_kind=kind)


def _ms(recs, names):
    return sum(r["end_ns"] - r["start_ns"] for r in recs if r["name"] in names) / 1e6


@pytest.fixture(scope="module")
def solved():
    """Two solves under a CPU profiler: their results and records, which
    stay in the program's list for the readers until the module ends."""
    from admm_optim_tpu_torch import xupdate_solve
    from admm_optim_tpu_torch.utils import profiling

    ctx = xupdate_solve.build(1, "cpu", torch.float64)
    bs = [xupdate_solve.random_rhs(ctx, seed=s) for s in (0, 1)]
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        res = [xupdate_solve.solve(ctx, b) for b in bs]
    yield res, profiling.spans()
    profiling.reset_spans()


def test_readers_on_the_card(solved):
    res, recs = solved
    want = {
        "host_syncs_per_solve": sum(r.inner_iters + 3 * r.rounds + 2 for r in res) / 2,
        "host_wait_ms_per_solve": _ms(recs, ("host.sync",)) / 2,
        "vcycle_host_ms_per_solve": _ms(recs, ("mg.vcycle",)) / 2,
        "exchange_host_ms_per_solve": _ms(recs, ("st.exchange", "st.exchange_df")) / 2,
    }
    run = _run(CARD)
    for name in READERS:
        got = harness.load_reader(name).read(run)
        assert got == pytest.approx(want[name], rel=1e-12), name
        assert got > 0
    assert sum(1 for r in recs if r["name"] == spans.ROOT) == 2
    assert {r["request"] for r in recs} == {0, 1}


def test_nothing_read_off_the_card(solved):
    for kind in ("cpu", ""):
        assert all(harness.load_reader(name).read(_run(kind)) is None for name in READERS)


def test_nothing_read_from_a_program_without_spans(solved, monkeypatch):
    """The parent of the spans: its utils.profiling has no spans()."""
    monkeypatch.setitem(sys.modules, spans.PROFILING, types.ModuleType(spans.PROFILING))
    assert all(harness.load_reader(name).read(_run(CARD)) is None for name in READERS)
    monkeypatch.delitem(sys.modules, spans.PROFILING)
    assert spans.records(_run(CARD)) is None


def test_nothing_read_without_a_root(solved, monkeypatch):
    from admm_optim_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [r for r in solved[1] if r["name"] != spans.ROOT])
    assert all(harness.load_reader(name).read(_run(CARD)) is None for name in READERS)
