"""ns_host_syncs_per_solve: the port's host.sync spans inside ns.newton per
traced re-solve, each a blocking device-to-host read or synchronization:
the Newton residual norms, the FGMRES cycle norms, the Hessenberg blocks
read for the least-squares solves and the recycle selection, and the
assembly clocks (NS Newton layer; benchmark.spans_ns).  None in a program
without an ns.newton span."""
from benchmark import spans_ns


def read(run):
    return spans_ns.count_per_solve(run, ("host.sync",))
