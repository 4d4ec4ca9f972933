"""stencil_roofline.ns: the least time the traced NS re-solves' lattice
operator applications need at the card's published memory bandwidth
(benchmark.cost_ns: the assembled Jacobian's applies and the
preconditioner's velocity V-cycles and B^T, from the program's Newton
iterates and linear iterations), as a percentage of the device's busy time
over those re-solves, which also holds the assembly, the line search and
the Krylov bookkeeping.  None off the card or for a card without a row in
peaks.json."""
from benchmark import cost_ns


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.peaks:
        return None
    solves = [r for r in run.traced_requests if "lin_iters" in r and "drag" in r]
    if not solves:
        return None
    nbytes = sum(cost_ns.request_bytes(run.config, r["newton"], r["lin_iters"]) for r in solves)
    return 100.0 * nbytes / run.peaks["hbm_bytes_per_s"] / run.trace.busy_s
