"""NaN/Inf debugging hooks (the port of admm_optim_tpu/utils/debug.py).

Two layers:
 * check_finite(phase, **arrays): host-side phase-boundary check used by the
   outer optimization loop when ProblemConfig.debug_nans is set; raises
   NonFiniteError naming the phase and array, so a silent NaN inside the
   ADMM loop surfaces as "phase X produced non-finite Y" instead of an
   unexplained failed step.  This is the layer ObstacleShapeOpt.run relies on.
 * enable_nan_debug(): torch.autograd.set_detect_anomaly(True).  It
   localizes a NaN only inside autograd: the drag gradient, J' and the
   transpose_M replay of the adjoint's preconditioner.  The forward solves
   run outside autograd, where only check_finite sees them.
"""
from __future__ import annotations

import torch


class NonFiniteError(RuntimeError):
    """A phase of the optimization loop produced a non-finite array."""

    def __init__(self, phase: str, name: str):
        super().__init__(
            f"non-finite values detected in phase '{phase}' (array '{name}'); "
            "run with torch.autograd.set_detect_anomaly(True) to localize it inside autograd"
        )
        self.phase = phase
        self.name = name


def enable_nan_debug() -> None:
    torch.autograd.set_detect_anomaly(True)


def check_finite(phase: str, **arrays) -> None:
    """Raise NonFiniteError naming the first non-finite array, if any."""
    for name, a in arrays.items():
        if a is None:
            continue
        if not bool(torch.isfinite(torch.as_tensor(a)).all()):
            raise NonFiniteError(phase, name)
