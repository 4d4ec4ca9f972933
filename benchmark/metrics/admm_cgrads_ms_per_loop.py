"""admm_cgrads_ms_per_loop: the summed duration of the port's admm.cgrads
spans per traced loop, in ms of the host's clock: the constraint
gradients B = dg/du and their exchange, once a Newton step (the ADMM
x-update Newton layer; benchmark.spans_admm).  Traced, so the profiler's
cost is in it.  None where the loops hold no admm.cgrads span, as in a
program that has no such span."""
from benchmark import spans_admm


def read(run):
    got = spans_admm.records(run)
    if got is None or not any(r["name"] == "admm.cgrads" for r in got[0]):
        return None
    return spans_admm.ms_per_loop(run, ("admm.cgrads",))
