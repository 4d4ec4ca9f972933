"""host_wait_ms_per_solve: the summed duration of the port's host.sync
spans per traced solve, in ms: the host blocked on the card (Krylov layer;
benchmark.spans).  Traced, so the profiler's cost is in it."""
from benchmark import spans


def read(run):
    return spans.ms_per_solve(run, ("host.sync",))
