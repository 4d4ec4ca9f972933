"""Make the references that chip_smoke.py holds the card's refs=1 runs to,
from the port itself in float64 on the CPU with the float32 presets:

  * pcd: tests/goldens/chip_pcd_ladder_refs1.npz, the refs=1 PCD ladder
    to visc 0.04 (chip_smoke.SMALL_VISC) with drag, adjoint and J'
    (chip_smoke.small_reference);
  * step: tests/goldens/chip_step_refs1.npz, one optimization step at 3D
    refs=1 from the cold start (chip_smoke.step_reference);
  * cli: tests/goldens/chip_cli_refs1.npz, the CLI on chip_smoke.CLI_ARGV
    with -x64 (chip_smoke.cli_reference).

Needs no card and no JAX; each takes minutes on the CPU.  Run from the
repository root:

    python tests/goldens/make_chip_reference.py [pcd] [step] [cli]
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


def pcd():
    t0 = time.perf_counter()
    ref = chip_smoke.small_reference()
    np.savez_compressed(chip_smoke.SMALL_REFERENCE, **ref)
    print(f"wrote {chip_smoke.SMALL_REFERENCE} in {time.perf_counter() - t0:.1f} s: rungs {ref['nu'].tolist()}, "
          f"Newton {ref['newton'].tolist()}, linear {ref['lin'].tolist()}, drag {float(ref['drag']):.10g}, "
          f"adjoint {int(ref['adjoint_iters'])} ({ref['adjoint_exit']}), |J'| {float(ref['jprime_norm']):.6e}")


def step():
    t0 = time.perf_counter()
    ref = chip_smoke.step_reference()
    np.savez_compressed(chip_smoke.STEP_REFERENCE, **ref)
    print(f"wrote {chip_smoke.STEP_REFERENCE} in {time.perf_counter() - t0:.1f} s: attempts "
          f"{ref['outcomes'].tolist()}, ADMM {ref['admm_iters'].tolist()}, Newton {ref['newton'].tolist()}, "
          f"adjoint {int(ref['adjoint_iters'])}, drag {float(ref['drag_init']):.10g} -> {float(ref['drag']):.10g}")


def cli():
    t0 = time.perf_counter()
    ref = chip_smoke.cli_reference()
    np.savez_compressed(chip_smoke.CLI_REFERENCE, **ref)
    print(f"wrote {chip_smoke.CLI_REFERENCE} in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v}" for k, v in ref.items()))


if __name__ == "__main__":
    which = sys.argv[1:] or ["pcd", "step", "cli"]
    if not set(which) <= {"pcd", "step", "cli"}:
        raise SystemExit(__doc__)
    for name in which:
        {"pcd": pcd, "step": step, "cli": cli}[name]()
