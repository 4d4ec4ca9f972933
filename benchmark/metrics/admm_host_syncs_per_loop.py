"""admm_host_syncs_per_loop: the port's host.sync spans inside admm.inner
per traced loop, each a blocking device-to-host read or synchronization:
the Newton loop's clock syncs, lane counts, flags and norms, CG's
active-lane counts and the ADMM loop's norms (ADMM x-update Newton layer;
benchmark.spans_admm)."""
from benchmark import spans_admm


def read(run):
    return spans_admm.count_per_loop(run, ("host.sync",))
