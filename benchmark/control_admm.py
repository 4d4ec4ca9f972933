"""Readings that set the ``admm_inner`` cells' correctness limits, at the
cell's own size, in one process (``benchmark.control.readings`` with this
cell's variants): the program's sound loops on many seeds (the lower
readings), the bf16 control and the three faults (the upper readings),
each planted under the timed path by the driver (``Driver.plant``).

    python3 benchmark/control_admm.py --workload r4-admm --seeds 11 12 ... --control-seeds 21 22 23

For every seed it makes the traffic's pool, runs one loop on each entry
and takes, for each number the check compares, the worst over those
loops, as a run's check does over its sampled requests.  Variants:
``program`` (as the configuration states it); the faults
``state_unchanged`` (lambda never updated), ``answer_altered`` (one
element of q moved by 1%), ``dlambda_zero`` (the x-update's DLambda
dropped); and last the control ``bf16`` (the operator, q, lambda and the
constraint values rounded to bfloat16, the precision below the
configuration's float32).  A number catches the variants whose least
reading is at least CAUGHT times its lower reading, and its upper reading
is the least of theirs.  The benchmark's runs never run this.  Prints one
JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import control, harness  # noqa: E402
from benchmark.drivers.admm_inner import CONTROL, FAULTS  # noqa: E402

CAUGHT = 30.0


def summarize(out: dict) -> dict:
    """{number: {"lower", "upper", "caught_by", <variant>: least reading}}."""
    summary = {}
    for number in next(iter(out["program"].values())):
        lower = max(r[number] for r in out["program"].values())
        least = {v: min(r[number] for r in out[v].values()) for v in out if v != "program"}
        caught = sorted(v for v, x in least.items() if x >= CAUGHT * lower)
        summary[number] = dict(lower=lower, upper=min((least[v] for v in caught), default=None), caught_by=caught,
                               **least)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", help="a cell of BENCHMARK.json")
    ap.add_argument("--config", help="a configuration file, with --traffic, instead of --workload")
    ap.add_argument("--traffic", help="a traffic name under benchmark/traffic")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.workload:
        _, config, traffic, _ = harness.resolve(harness.load_manifest(), args.workload)
    else:
        config = harness.load_json(pathlib.Path(args.config))
        traffic = harness.load_json(harness.ROOT / "traffic" / f"{args.traffic}.json")
    seeds = {"program": args.seeds, **{f: args.control_seeds for f in FAULTS}, CONTROL: args.control_seeds}
    out = control.readings(config, traffic, seeds, args.device)
    summary = summarize(out)
    for number, s in summary.items():
        harness.log(f"{number}: lower {s['lower']:.6e}; " + ", ".join(f"{v} {s[v]:.6e}" for v in (*FAULTS, CONTROL))
                    + f"; caught by {s['caught_by']}")
    harness.log(f"card: {harness.card_state()}")
    print(json.dumps({"config": config["name"], "readings": out, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
