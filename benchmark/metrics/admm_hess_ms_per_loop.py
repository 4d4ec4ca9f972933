"""admm_hess_ms_per_loop: the summed duration of the port's admm.hess spans
per traced loop, in ms of the host's clock: assembling Lambda . g'' into
the Hessian stencil once a Newton step (the Hessian stencil assembly
layer; benchmark.spans_admm).  The Newton loop synchronizes just before
and just after it, in host.sync spans of their own, so this is the host's
dispatch of the assembly, and its device time the wait of the sync after
it; traced, so the profiler's cost is in it."""
from benchmark import spans_admm


def read(run):
    return spans_admm.ms_per_loop(run, ("admm.hess",))
