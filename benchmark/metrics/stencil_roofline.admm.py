"""stencil_roofline.admm: the least time the traced ADMM loops' stencil
applications need at the card's published memory bandwidth
(benchmark.cost_admm: every Newton step's lane-batched CG solve of H and
its V-cycles, each stencil streamed once for the 1+m lanes, and its single
apply of A, from the program's Newton steps and batched iterations), as a
percentage of the device's busy time over those loops, which also holds
the Hessian assembly and the per-cell passes.  None off the card or for a
card without a row in peaks.json."""
from benchmark import cost_admm


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.peaks:
        return None
    loops = [r for r in run.traced_requests if "batch_iters" in r]
    if not loops:
        return None
    nbytes = sum(cost_admm.loop_bytes(run.config, r["newton"], r["batch_iters"]) for r in loops)
    return 100.0 * nbytes / run.peaks["hbm_bytes_per_s"] / run.trace.busy_s
