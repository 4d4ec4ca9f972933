"""lane_cg_iters_per_loop: the mean of ADMMState.total_lin_iters over the
window's loops, the x-update's CG iterations summed over its 1+m lanes and
its solves (Krylov layer; a program counter)."""


def read(run):
    its = [r["lin_iters"] for r in run.requests if "lin_iters" in r]
    return sum(its) / len(its) if its else None
