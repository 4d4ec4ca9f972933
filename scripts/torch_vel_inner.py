#!/usr/bin/env python3
"""The PCD ladder's visc 0.02 rung at 3D refs=2 on one GPU with 1 and 2
Richardson steps of the velocity V-cycle per preconditioner apply
(ns_run.build(..., vel_inner=)), in turns 1, 2, 2, 1.

    python3 scripts/torch_vel_inner.py

Builds the stencil kernels, climbs the PCD ladder 0.16 -> 0.08 -> 0.04 in
float32 with the NS float32 presets (as chip_smoke.py's pcd phase does),
then solves the 0.02 rung from the 0.04 state four times, each with no
recycle space: per solve its Newton and linear counts, |R|, seconds and ms
per linear iteration outside assembly (chip_smoke.vel_inner_rung).  The
card's name and power limit come first."""
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from admm_optim_tpu_torch import _build, ns_run  # noqa: E402

ORDER = (1, 2, 2, 1)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_vel_inner: torch.cuda.is_available() is False; this run needs a GPU")
    cs.log(f"[device] {cs.nvidia_smi()}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build()
    _build.lib()
    ctx = ns_run.build(2, visc=cs.PCD_VISC, pressure_precond="pcd")
    lad = ns_run.solve_ladder(ctx, visc=0.04)
    cs.report_rungs("vel_inner", lad.rungs)
    runs = {1: [], 2: []}
    for vi in ORDER:
        res, secs, ms = cs.vel_inner_rung(ctx.at_visc(cs.PCD_VISC), lad.s, vi, tag="vel_inner")
        cs.check(res.converged, f"vel_inner {vi}: the visc {cs.PCD_VISC} rung converged")
        runs[vi].append((sum(res.lin_iters), secs, ms))
    for vi, rs in runs.items():
        cs.log(f"[vel_inner] {vi}: linear {[r[0] for r in rs]}, seconds {[round(r[1], 3) for r in rs]}, "
               f"ms per linear iteration {[round(r[2], 2) for r in rs]}")


if __name__ == "__main__":
    main()
