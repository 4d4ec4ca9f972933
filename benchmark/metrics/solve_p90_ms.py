"""solve_p90_ms: the 90th percentile of the wall times of all the window's
solves, each ending synchronized, in ms (inclusive quantiles; the run
prints the sample count)."""
import statistics


def read(run):
    ms = [r["seconds"] * 1e3 for r in run.requests]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
