"""Readings that set a cell's correctness limits, at the cell's own size,
in one process: the program's sound runs on many seeds (the lower
readings), the control (the upper readings) and the faults the cell can
have, each planted under the timed path by the cell's driver
(``Driver.plant``).

    python3 benchmark/control.py --workload r4-ir-solve --seeds 11 12 ... --control-seeds 21 22 23

For every seed it makes the traffic's pool, serves each entry once and
takes, for each number the check compares, the worst over those answers,
as a run's check does over its sampled requests.  Variants: ``program``
(as the configuration states it), ``bf16_operator`` (the control: every
level's stencil rounded to bfloat16, the precision below the
configuration's float32 operators; the port's own bf16 smoother stream
carried to every apply), and the faults ``state_unchanged``,
``answer_altered`` and ``one_round``.  The benchmark's runs never run
this.  Prints one JSON line of readings.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402

CONTROL = "bf16_operator"
FAULTS = ("state_unchanged", "answer_altered", "one_round")


def readings(config: dict, traffic: dict, seeds: dict, device, log=harness.log) -> dict:
    """{variant: {seed: {number: worst reading over the pool}}}; the
    variants run in the order of `seeds`, the control (which changes the
    program in place) last."""
    import torch

    driver = harness.load_driver(traffic["request"]).Driver(config, traffic, {}, 0, device, log)
    driver.setup()
    order = [v for v in seeds if v != CONTROL] + [v for v in seeds if v == CONTROL]
    out = {}
    for variant in order:
        driver.plant(variant)
        out[variant] = {}
        for seed in seeds[variant]:
            t0 = time.perf_counter()
            driver.set_pool(seed)
            kept = []
            for i in range(int(traffic["pool"]["size"])):
                rec, answer = driver.request(i)
                kept.append((rec, driver.answer_vertex(answer)))
            out[variant][seed] = driver.readings(kept, driver.pool_vertex(seed))
            log(f"{variant} seed {seed}: {out[variant][seed]} ({time.perf_counter() - t0:.1f} s)")
            del kept
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return out


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
    out = readings(config, traffic, seeds, args.device)
    summary = {}
    for number in next(iter(out["program"].values())):
        lower = max(r[number] for r in out["program"].values())
        upper = min(r[number] for r in out[CONTROL].values())
        summary[number] = {"lower": lower, "upper": upper}
        harness.log(f"{number}: lower reading {lower:.6e} (program, {len(args.seeds)} seeds); upper reading "
                    f"{upper:.6e} (control, {len(args.control_seeds)} seeds); ratio {upper / lower:.1f}")
    harness.log(f"card: {harness.card_state()}")
    print(json.dumps({"config": config["name"], "readings": out, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
