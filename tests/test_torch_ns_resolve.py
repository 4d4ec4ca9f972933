"""The r2-ns-newton cell's driver (benchmark/drivers/ns_resolve.py) end to
end through the benchmark's harness and the cell's limits, on the CPU at
3D refs=0 (7,254 NS unknowns), in the cell's precision, float32, at visc
0.16, so that the set-up ladder is one rung: set-up, one re-solve on a
deformed mesh from the ladder's state, and the float64 check.  The planted
faults and the control: benchmark/tests/test_bench_ns.py."""
import time

import pytest
import torch

from admm_optim_tpu_torch import ns_run
from benchmark import harness

torch.set_num_threads(1)

CONFIG = harness.load_json(harness.ROOT / "tests" / "data" / "channel3d-r0-ns.json")
TRAFFIC = harness.load_json(harness.ROOT / "traffic" / "ns-resolve.json")
LIMITS = harness.load_json(harness.ROOT / "limits" / "r2-ns-newton.json")
CELL = {"name": "r0-ns", "config": CONFIG["name"], "traffic": "ns-resolve", "chips": 1}
SEED = 2**31 + 8191


def test_the_driver_end_to_end():
    """One re-solve through the cell's driver, harness and limits
    (limits/r2-ns-newton.json, set on the card at refs=2): set-up's ladder,
    the request on a deformed mesh, the float64 check."""
    r = harness.execute(CELL, CONFIG, TRAFFIC, LIMITS, [], SEED, 0.0, False, "cpu", time.monotonic())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 1
    assert r["checks"]["ns_res_rel"]["value"] < 1e-4 and r["checks"]["drag_err"]["value"] < 1e-6


def test_set_up_refuses_a_program_without_the_graphs(monkeypatch):
    """A program whose Newton linear solves do not take the CUDA graphs
    that the configuration states (a build without ``graphs``, as before
    them) stops at set-up, before the ladder."""
    monkeypatch.setattr(ns_run.NSContext, "graphed", property(lambda self: False))
    with pytest.raises(RuntimeError, match="replay CUDA graphs"):
        harness.execute(CELL, CONFIG, TRAFFIC, LIMITS, [], SEED, 0.0, False, "cpu", time.monotonic())
