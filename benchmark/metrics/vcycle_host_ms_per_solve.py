"""vcycle_host_ms_per_solve: the summed duration of the port's mg.vcycle
spans per traced solve, in ms of the host's clock: the V-cycles' dispatch,
and their waits where the card's queue is full (V-cycle and exchange
dispatch layer; benchmark.spans).  Traced, so the profiler's cost is in it."""
from benchmark import spans


def read(run):
    return spans.ms_per_solve(run, ("mg.vcycle",))
