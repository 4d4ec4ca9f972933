"""ns_line_search_ms_per_solve: the summed duration of the port's
ns.line_search spans per traced re-solve, in ms of the host's clock: the
acceptBest line search's residual evaluations and its one read (NS Newton
layer; benchmark.spans_ns).  Traced, so the profiler's cost is in it.
None in a program without such spans."""
from benchmark import spans_ns


def read(run):
    return spans_ns.ms_per_solve(run, ("ns.line_search",))
