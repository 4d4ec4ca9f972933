"""cg_iters_per_solve: the mean of IRResult.inner_iters over the window's
solves (Krylov layer; a program counter)."""


def read(run):
    its = [r["inner_iters"] for r in run.requests if "inner_iters" in r]
    return sum(its) / len(its) if its else None
