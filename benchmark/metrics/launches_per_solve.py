"""launches_per_solve: host-side kernel and graph launch calls the profiler
records over the traced requests (tracing.LAUNCH_CALLS), per request (the
V-cycle and exchange dispatch layer)."""


def read(run):
    if run.trace is None or run.trace.requests == 0 or run.trace.launches == 0:
        return None
    return run.trace.launches / run.trace.requests
