"""host_syncs_per_solve: the port's host.sync spans per traced solve, each
a blocking device-to-host read (krylov.cg's active-lane count, cg_ir_p's
convergence flags and iteration count): inner_iters + 3 x rounds + 2
(Krylov layer; benchmark.spans)."""
from benchmark import spans


def read(run):
    return spans.count_per_solve(run, ("host.sync",))
