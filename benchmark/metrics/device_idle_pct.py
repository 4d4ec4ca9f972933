"""device_idle_pct.<cells>: 100 * (1 - busy / window) over the traced
requests, busy the union of the device's activity intervals in the trace,
window the host clock over the same requests.  One reader for every split
of the metric by the end-to-end metric it moves (``.solve``)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
