"""On the card: one short run of each cell through the command the
benchmark's checks use, and the control and the one-round fault at the
refs=4 cell's own size."""
import json
import subprocess
import sys

import pytest

from benchmark import control, harness

M = harness.load_manifest()


@pytest.mark.card
@pytest.mark.parametrize("cell", [c["name"] for c in M["workloads"]])
def test_cell_runs(card, cell):
    out = subprocess.run([sys.executable, *M["command"][1:], "--workload", cell, "--seed", "4000000017",
                          "--seconds", "5", "--trace", "0"], cwd=harness.REPO, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert {m["name"] for m in harness.cell_metrics(M, cell, False)} == set(r["metrics"])


@pytest.mark.card
def test_control_at_refs4(card):
    cfg = harness.load_json(harness.ROOT / "configs" / "channel3d-r4.json")
    tr = harness.load_json(harness.ROOT / "traffic" / "ir-solve.json")
    seeds = {"program": [1, 2, 3], "one_round": [4, 5, 6], "bf16_operator": [4, 5, 6]}
    out = control.readings(cfg, tr, seeds, "cuda")
    limit = harness.load_json(harness.ROOT / "limits" / "r4-ir-solve.json")["limits"]["true_res_max"]
    lower = max(r["true_res_max"] for r in out["program"].values())
    upper = min(r["true_res_max"] for v in ("one_round", "bf16_operator") for r in out[v].values())
    assert lower < limit < upper
