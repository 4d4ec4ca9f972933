"""Text telemetry writers matching the reference's gnuplot.write_data files.

The reference dumps whitespace-separated columns via ``gnuplot.write_data``:
``__Drag.txt`` (2d_admm.lua:1349), ``__Iterations_per_step.txt`` (2d:1383),
``__ADMMStats_step_N_.txt`` (2d:1221), ``__NewtonStats...`` (2d:1256-1259),
``__Failure_Data.txt`` (2d:1321).  Same formats here so downstream gnuplot
scripts keep working, plus a structured JSONL mirror for modern tooling.

The port's copy of admm_optim_tpu/io/telemetry.py: the same files, byte for
byte, from the same records.  Every value must be a Python int or float
(str() of a tensor writes "tensor(...)", and json.dumps raises on one), so
ObstacleShapeOpt.run converts before it writes.
"""
from __future__ import annotations

import json
import os


def write_columns(path: str, columns: list[list]) -> None:
    """gnuplot.write_data format: row index implicit, columns whitespace-sep."""
    n = max((len(c) for c in columns), default=0)
    with open(path, "w") as f:
        for i in range(n):
            row = [c[i] if i < len(c) else "" for c in columns]
            f.write("\t".join(str(x) for x in row) + "\n")


class TelemetryWriter:
    """Per-run output directory with the reference's file set + JSONL."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._jsonl = open(os.path.join(out_dir, "history.jsonl"), "a")

    def log_step(self, record: dict) -> None:
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def write_drag(self, steps, drag, norm_drag, drag_diff, shape_deriv):
        write_columns(
            os.path.join(self.out_dir, "__Drag.txt"),
            [steps, drag, norm_drag, drag_diff, shape_deriv],
        )

    def write_iterations(self, steps, admm_steps, thresholds, newton, lin_total,
                         solver_iters=None, dim=2):
        """__Iterations_per_step.txt.  solver_iters: per-step tuples of
        per-solve-slot Krylov sums (rhs, B_vol, B_x, B_y(, B_z)).

        2D column layout (2d_admm.lua:1383-1384): step, ADMM steps, sigma
        threshold, Newton steps, total linear, RHS, Bvol, Bx, By, Large.
        3D layout (3d_admm.lua:1416-1417) drops the ADMM-steps/threshold
        columns: step, Newton, total linear, RHS, Bvol, Bx, By, Bz, Large.
        The reference's "large problem" solve is eliminated algebraically
        here (optim.admm module docstring), so its column is 0."""
        if solver_iters is None:
            solver_iters = [() for _ in steps]
        m1 = max((len(si) for si in solver_iters), default=0)
        per = [
            [int(si[j]) if j < len(si) else 0 for si in solver_iters]
            for j in range(m1)
        ]
        large = [0 for _ in steps]
        if dim == 3:
            cols = [steps, newton, lin_total] + per + [large]
        else:
            cols = [steps, admm_steps, thresholds, newton, lin_total] + per + [large]
        write_columns(
            os.path.join(self.out_dir, "__Iterations_per_step.txt"), cols
        )

    def write_failures(self, fsteps, at_step, fdrag, fdiff, fthresh):
        write_columns(
            os.path.join(self.out_dir, "__Failure_Data.txt"),
            [fsteps, at_step, fdrag, fdiff, fthresh],
        )

    def write_newton_stats(self, step, rows: list[list]) -> None:
        """__NewtonStats_step_N_.txt (2d_admm.lua:1256-1257): per Newton
        iteration of the LAST ADMM iteration, columns
        [step, norm_sum, |delta_u|, |delta_Lambda|, |Lu|]."""
        cols = [
            [i + 1 for i in range(len(rows))],
            [r[0] for r in rows],
            [r[1] for r in rows],
            [r[2] for r in rows],
            [r[3] for r in rows],
        ]
        write_columns(
            os.path.join(self.out_dir, f"__NewtonStats_step_{step}_.txt"), cols
        )

    def write_newton_iterations(self, step, rows: list[list]) -> None:
        """__NewtonIterations_step_N_.txt (2d_admm.lua:1258-1259): columns
        [step, rhs_iters, Bvol_iters, Bx_iters, By_iters(, Bz_iters),
        large_iters].  rows carry [.., .., .., .., rhs, vol, bx, by(, bz)];
        the reference's extra 'large problem' solve is eliminated
        algebraically here (optim.admm module docstring) so its column is a
        constant 0."""
        steps = [i + 1 for i in range(len(rows))]
        cols = [steps, [int(r[4]) for r in rows]]
        m = len(rows[0]) - 5 if rows else 0
        for j in range(m):
            cols.append([int(r[5 + j]) for r in rows])
        cols.append([0 for _ in rows])  # LargeSolver (eliminated)
        write_columns(
            os.path.join(self.out_dir, f"__NewtonIterations_step_{step}_.txt"),
            cols,
        )

    def write_admm_stats(self, step, rows: dict):
        cols = [rows[k] for k in sorted(rows)]
        write_columns(
            os.path.join(self.out_dir, f"__ADMMStats_step_{step}_.txt"), cols
        )

    def close(self):
        self._jsonl.close()
