"""hess_kernel_share: of the port's admm.hess spans over the traced ADMM
loops, the share whose attribute path is "kernel": Hessian stencils that
the one-launch CUDA kernel assembled (the Hessian stencil assembly layer;
benchmark.spans_admm).  None where no admm.hess span carries the
attribute, as in a program that assembles every Hessian with the plain
form and does not say so."""
from benchmark import spans_admm


def read(run):
    got = spans_admm.records(run)
    if got is None:
        return None
    paths = [r["attrs"].get("path") for r in got[0] if r["name"] == "admm.hess"]
    if not any(p is not None for p in paths):
        return None
    return sum(1 for p in paths if p == "kernel") / len(paths)
