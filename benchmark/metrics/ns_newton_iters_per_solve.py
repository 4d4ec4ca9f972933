"""ns_newton_iters_per_solve: the mean of NewtonResult.iters over the
window's NS re-solves, the Newton iterates of one re-solve (NS Newton
layer; a program counter)."""


def read(run):
    its = [r["newton"] for r in run.requests if "newton" in r and "drag" in r]
    return sum(its) / len(its) if its else None
