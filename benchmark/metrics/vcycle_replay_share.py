"""vcycle_replay_share: of the port's mg.vcycle spans over the traced
solves, the share whose attribute graph is "replay": V-cycles the host
launched as one CUDA graph (V-cycle and exchange dispatch layer;
benchmark.spans).  None where no mg.vcycle span carries the attribute, as
in a program that runs every cycle eagerly and does not say so."""
from benchmark import spans


def read(run):
    got = spans.records(run)
    if got is None:
        return None
    modes = [r["attrs"].get("graph") for r in got[0] if r["name"] == "mg.vcycle"]
    if not any(m is not None for m in modes):
        return None
    return sum(1 for m in modes if m == "replay") / len(modes)
