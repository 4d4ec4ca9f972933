"""ns_lin_iters_per_solve: the mean over the window's NS re-solves of
NewtonResult.lin_iters summed over the iterates, the FGMRES iterations of
one re-solve in chunk units with the recycle space's re-imaging applies
(Krylov layer; a program counter)."""


def read(run):
    its = [r["lin_iters"] for r in run.requests if "lin_iters" in r and "drag" in r]
    return sum(its) / len(its) if its else None
