"""The port's own spans over a run's traced requests, for the metric
readers of the program_span source.

``admm_optim_tpu_torch.utils.profiling`` records a span only while a
torch.profiler profile records, and the harness profiles exactly the
traced requests, so after the window its ``spans()`` holds theirs.  Each
request is one root span ``xupdate.solve``; a reader divides by their
number.

Nothing is read (None) off the card, where a host read waits for nothing
and host time is compute rather than dispatch, from a program without
spans, or where no root was recorded.  The program is not imported here:
a run has loaded it or there is nothing to read.
"""
from __future__ import annotations

import sys

ROOT = "xupdate.solve"
PROFILING = "admm_optim_tpu_torch.utils.profiling"


def records(run) -> tuple[list, int] | None:
    """(the span records, the number of roots), or None."""
    if run.device_kind in ("", "cpu"):
        return None
    read = getattr(sys.modules.get(PROFILING), "spans", None)
    if read is None:
        return None
    recs = read()
    roots = sum(1 for r in recs if r["name"] == ROOT)
    return (recs, roots) if roots else None


def count_per_solve(run, names: tuple) -> float | None:
    """Records named in names, per root."""
    got = records(run)
    if got is None:
        return None
    recs, roots = got
    return sum(1 for r in recs if r["name"] in names) / roots


def ms_per_solve(run, names: tuple) -> float | None:
    """Summed duration of the records named in names, in ms per root (the
    names must not nest in one another, or time is counted twice)."""
    got = records(run)
    if got is None:
        return None
    recs, roots = got
    return sum(r["end_ns"] - r["start_ns"] for r in recs if r["name"] in names) / roots / 1e6
