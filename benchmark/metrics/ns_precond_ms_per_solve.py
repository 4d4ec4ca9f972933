"""ns_precond_ms_per_solve: the summed duration of the port's ns.precond
spans per traced re-solve, in ms of the host's clock: the block
preconditioner's applies (the velocity V-cycle and B^T), their dispatch
and the waits where the card's queue is full (NS preconditioner layer;
benchmark.spans_ns).  Traced, so the profiler's cost is in it.  None in a
program without such spans."""
from benchmark import spans_ns


def read(run):
    return spans_ns.ms_per_solve(run, ("ns.precond",))
