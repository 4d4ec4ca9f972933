"""newton_iters_per_loop: the mean of ADMMState.total_newton over the
window's loops, the x-update Newton steps of 5 ADMM iterations (ADMM
x-update Newton layer; a program counter)."""


def read(run):
    its = [r["newton"] for r in run.requests if "newton" in r]
    return sum(its) / len(its) if its else None
