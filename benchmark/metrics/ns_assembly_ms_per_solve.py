"""ns_assembly_ms_per_solve: the summed duration of the port's ns.assemble
spans per traced re-solve, in ms of the host's clock: the per-iterate
velocity V-cycle data and the assembled Jacobian, each between two
synchronizations, so their device time is in it (NS assembly layer;
benchmark.spans_ns).  Traced, so the profiler's cost is in it.  None in a
program without such spans."""
from benchmark import spans_ns


def read(run):
    return spans_ns.ms_per_solve(run, ("ns.assemble",))
