"""cgrads_kernel_share: of the port's admm.cgrads spans over the traced ADMM
loops, the share whose attribute path is "kernel": constraint gradients
B = dg/du that the one-launch CUDA kernel computed (the ADMM x-update
Newton layer; benchmark.spans_admm).  None where no admm.cgrads span
carries the attribute, as in a program that has no such span."""
from benchmark import spans_admm


def read(run):
    got = spans_admm.records(run)
    if got is None:
        return None
    paths = [r["attrs"].get("path") for r in got[0] if r["name"] == "admm.cgrads"]
    if not any(p is not None for p in paths):
        return None
    return sum(1 for p in paths if p == "kernel") / len(paths)
