"""The port's own spans over a run's traced ADMM loops, for the metric
readers of the program_span source of the ``admm_inner`` cells.

Each loop is one ``admm.inner`` span; a reader counts or times the records
that descend from one (an ``admm.inner`` inside another counts once) and
divides by the number of loops.  As ``benchmark/spans.py``: nothing is
read (None) off the card, from a program without spans, or where no loop
was recorded, and the program is not imported here.
"""
from __future__ import annotations

import sys

ROOT = "admm.inner"
PROFILING = "admm_optim_tpu_torch.utils.profiling"


def under_loops(recs: list) -> tuple[list, int]:
    """(the records inside an admm.inner span, the number of outermost
    admm.inner spans).  Records come in the order they opened, a parent
    before its children."""
    inside, out, loops = [], [], 0
    for r in recs:
        parent_in = r["parent"] is not None and inside[r["parent"]]
        inside.append(parent_in or r["name"] == ROOT)
        if parent_in:
            out.append(r)
        elif r["name"] == ROOT:
            loops += 1
    return out, loops


def records(run) -> tuple[list, int] | None:
    """(the records inside the loops, the number of loops), or None."""
    if run.device_kind in ("", "cpu"):
        return None
    read = getattr(sys.modules.get(PROFILING), "spans", None)
    if read is None:
        return None
    recs, loops = under_loops(read())
    return (recs, loops) if loops else None


def count_per_loop(run, names: tuple) -> float | None:
    got = records(run)
    if got is None:
        return None
    recs, loops = got
    return sum(1 for r in recs if r["name"] in names) / loops


def ms_per_loop(run, names: tuple) -> float | None:
    """Summed duration of the records named in names, in ms per loop (the
    names must not nest in one another)."""
    got = records(run)
    if got is None:
        return None
    recs, loops = got
    return sum(r["end_ns"] - r["start_ns"] for r in recs if r["name"] in names) / loops / 1e6
