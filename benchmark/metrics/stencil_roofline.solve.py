"""stencil_roofline.solve: the least time the traced solves' stencil
applications need at the card's published memory bandwidth (benchmark.cost:
W in the configuration's storage, x read once, y written once, counted from
the V-cycle structure and each solve's rounds and CG iterations), as a
percentage of the device's busy time over those solves.  It counts the same
work whatever kernels implement it.  None off the card or for a card
without a row in peaks.json."""
from benchmark import cost


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.peaks:
        return None
    nbytes = sum(cost.ir_solve_bytes(run.config, r["rounds"], r["inner_iters"]) for r in run.traced_requests)
    return 100.0 * nbytes / run.peaks["hbm_bytes_per_s"] / run.trace.busy_s
