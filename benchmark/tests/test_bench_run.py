"""A whole run on the CPU at refs=1, past the look for a card: the result
line, the traced run, and correct coming out false under the control and
under each fault a solve cell can have, planted under the timed path."""
import json
import subprocess
import sys
import time

import pytest

from benchmark import control, harness

CONFIG = harness.load_json(harness.ROOT / "tests" / "data" / "channel3d-r1.json")
TRAFFIC = harness.load_json(harness.ROOT / "traffic" / "ir-solve.json")
LIMITS = harness.load_json(harness.ROOT / "tests" / "data" / "limits-r1-ir-solve.json")
CELL = {"name": "r1-ir-solve", "config": "channel3d-r1", "traffic": "ir-solve", "chips": 1}
M = harness.load_manifest()
E2E = harness.cell_metrics(M, "r5-ir-solve", False)
PER_LAYER = harness.cell_metrics(M, "r5-ir-solve", True)
SEED = 2**31 + 977


def _run(trace=False, hook=None, seconds=0.6, seed=SEED):
    specs = PER_LAYER if trace else E2E
    return harness.execute(CELL, CONFIG, TRAFFIC, LIMITS, specs, seed, seconds, trace, "cpu", time.monotonic(),
                           driver_hook=hook)


def test_sound_run():
    r = _run()
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"setup_s", "solve_dof_per_s", "solve_p90_ms"}
    assert r["checks"]["true_res_max"]["value"] <= LIMITS["limits"]["true_res_max"]
    json.dumps(r)


def test_traced_run():
    r = _run(trace=True)
    assert list(r)[-1] == "checks" and "breakdown" in r and r["correct"]
    # off the card the trace has no device activity: only the program's
    # own counter and the benchmark's clock are read
    assert set(r["metrics"]) == {"assembly_s", "cg_iters_per_solve"}
    assert r["device"]["window_s"] > 0


@pytest.mark.parametrize("kind", ["state_unchanged", "answer_altered", "one_round"])
def test_fault_is_not_correct(kind):
    r = _run(hook=lambda d: d.plant(kind))
    assert not r["correct"]
    assert r["checks"]["true_res_max"]["value"] > r["checks"]["true_res_max"]["limit"]


def test_control_is_not_correct():
    r = _run(hook=lambda d: d.plant("bf16_operator"))
    assert not r["correct"]
    assert r["checks"]["true_res_max"]["value"] > 10 * LIMITS["limits"]["true_res_max"]


def test_unconverged_solves_are_failures():
    def hook(driver):
        solve = driver.program["solve"]
        driver.program["solve"] = lambda ctx, b: solve(ctx, b)._replace(converged=False)

    r = _run(hook=hook)
    assert not r["correct"] and r["failed"] == r["attempted"]


def test_limit_between_readings():
    """The test configuration's limit sits between the program's readings
    over a dozen seeds and those of the control and of the one-round fault,
    with more room above the lower, and below every answer the fault gives,
    so that a run catches it whichever answers it samples."""
    seeds = {"program": list(range(301, 313)), "one_round": [401, 402, 403], "bf16_operator": [401, 402, 403]}
    lines = []
    out = control.readings(CONFIG, TRAFFIC, seeds, "cpu", log=lines.append)
    fault, answers = [], []
    for line in map(str, lines):
        if "true relative residual" in line:
            answers.append(float(line.split("residual ")[1].split()[0]))
        elif " seed " in line:
            if line.startswith("one_round"):
                fault += answers
            answers = []
    lower = max(r["true_res_max"] for r in out["program"].values())
    upper = min(min(r["true_res_max"] for r in out["bf16_operator"].values()), min(fault))
    limit = LIMITS["limits"]["true_res_max"]
    assert len(fault) == 3 * TRAFFIC["pool"]["size"]
    assert upper >= 3 * lower and lower < limit < upper and limit / lower > upper / limit


def test_imports_no_jax():
    """Neither the harness, its driver and readers, the program they load,
    nor a run loads JAX or the JAX package (by whole top-level name); the
    reference and the yardstick load nothing of the program."""
    code = f"""
import sys, time
sys.path.insert(0, {str(harness.REPO)!r})
from benchmark import cost, meshgen, pools, reference
assert not [m for m in sys.modules if m.split('.')[0].startswith('admm_optim_tpu')], 'yardstick loads the program'
from benchmark import harness, control, run
m = harness.load_manifest()
for s in m['per_layer'] + m['end_to_end']:
    harness.load_reader(s['name'])
specs = harness.cell_metrics(m, 'r5-ir-solve', True)
cfg = harness.load_json(harness.ROOT / 'tests' / 'data' / 'channel3d-r1.json')
tr = harness.load_json(harness.ROOT / 'traffic' / 'ir-solve.json')
cell = dict(name='t', config='channel3d-r1', traffic='ir-solve', chips=1)
lim = harness.load_json(harness.ROOT / 'tests' / 'data' / 'limits-r1-ir-solve.json')
r = harness.execute(cell, cfg, tr, lim, specs, 5, 0.3, True, 'cpu', time.monotonic())
assert r['correct']
assert 'admm_optim_tpu_torch' in sys.modules
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
