"""The port's own spans over a run's traced NS re-solves, for the metric
readers of the program_span source of the ``ns_resolve`` cells.

Each re-solve is one ``ns.newton`` span; a reader counts or times the
records that descend from one (an ``ns.newton`` inside another counts
once) and divides by the number of re-solves.  As ``benchmark/spans.py``:
nothing is read (None) off the card, from a program without spans, or
where no re-solve was recorded, and the program is not imported here.
"""
from __future__ import annotations

import sys

ROOT = "ns.newton"
PROFILING = "admm_optim_tpu_torch.utils.profiling"


def under_roots(recs: list) -> tuple[list, int]:
    """(the records inside an ns.newton span, the number of outermost
    ns.newton spans).  Records come in the order they opened, a parent
    before its children."""
    inside, out, roots = [], [], 0
    for r in recs:
        parent_in = r["parent"] is not None and inside[r["parent"]]
        inside.append(parent_in or r["name"] == ROOT)
        if parent_in:
            out.append(r)
        elif r["name"] == ROOT:
            roots += 1
    return out, roots


def records(run) -> tuple[list, int] | None:
    """(the records inside the re-solves, the number of re-solves), or None."""
    if run.device_kind in ("", "cpu"):
        return None
    read = getattr(sys.modules.get(PROFILING), "spans", None)
    if read is None:
        return None
    recs, roots = under_roots(read())
    return (recs, roots) if roots else None


def count_per_solve(run, names: tuple) -> float | None:
    got = records(run)
    if got is None:
        return None
    recs, roots = got
    return sum(1 for r in recs if r["name"] in names) / roots


def ms_per_solve(run, names: tuple) -> float | None:
    """Summed duration of the records named in names, in ms per re-solve
    (the names must not nest in one another); None where none is recorded,
    as in a program without such spans."""
    got = records(run)
    if got is None or not any(r["name"] in names for r in got[0]):
        return None
    recs, roots = got
    return sum(r["end_ns"] - r["start_ns"] for r in recs if r["name"] in names) / roots / 1e6
