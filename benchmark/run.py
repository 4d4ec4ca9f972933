"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload r4-ir-solve --seed 7 --seconds 45 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks`` comes last, each number compared beside its
limit.  Everything else goes to standard error, ending with those checks.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), or when a module of JAX or of the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402

T_START = harness.process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = harness.load_manifest()
    cell, config, traffic, limits = harness.resolve(manifest, args.workload)
    parts = {"start_s": time.monotonic() - T_START}
    t0 = time.perf_counter()
    import torch

    chips = int(cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        harness.log(f"this cell needs {chips} CUDA device(s); found {found}")
        return 2
    torch.zeros(1, device="cuda")
    parts["torch_s"] = time.perf_counter() - t0
    specs = harness.cell_metrics(manifest, cell["name"], bool(args.trace))
    with contextlib.redirect_stdout(sys.stderr):
        result = harness.execute(cell, config, traffic, limits, specs, args.seed, args.seconds, bool(args.trace),
                                 "cuda", T_START, parts=parts)
    bad = harness.forbidden_modules()
    if bad:
        harness.log("modules of JAX or of the JAX package are loaded: " + ", ".join(bad))
        return 3
    harness.log(f"result: correct {result['correct']}, attempted {result['attempted']}, "
                f"failed {result['failed']}, memory_peak_bytes {result['device']['memory_peak_bytes']}")
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} limit {c['limit']!r} "
                    f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
