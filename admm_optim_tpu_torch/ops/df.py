"""Double-float (two-float32) arithmetic (port of admm_optim_tpu/ops/df.py).

Critical vectors are carried as an unevaluated pair ``(hi, lo)`` with
``hi = fl(hi + lo)``, roughly 48 significand bits, and residuals are
computed with error-free transformations (Knuth two-sum, Dekker/Veltkamp
two-prod).  Works unchanged in float64 (giving ~double-double); the CPU
tests exploit that.

The JAX package wraps the EFT operands in optimization barriers because
XLA fuses and simplifies elementwise chains (``_ob``, ``barrier_pair``).
Eager PyTorch launches one kernel per op, each rounding its result, so
nothing here is fused or contracted and the barriers have no counterpart.
Never run these functions under ``torch.compile``: a fusing compiler may
fold the identities away (tests/test_torch_df.py checks exactness).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DF(NamedTuple):
    """Unevaluated sum hi + lo (hi carries the leading bits)."""

    hi: torch.Tensor
    lo: torch.Tensor


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Veltkamp split with split constant 2^ceil(p/2)+1: 2^12+1 for
    float32, 2^27+1 for float64."""
    c = a * (4097.0 if a.dtype == torch.float32 else 134217729.0)
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, 17 flops)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def from_f(x) -> DF:
    return DF(x, torch.zeros_like(x))


def renorm(hi, lo) -> DF:
    """Safe renormalization: unconditional two_sum (fast_two_sum needs
    |hi| >= |lo|, which fails under the cancellation of b - Ax)."""
    return DF(*two_sum(hi, lo))


def add(x: DF, y: DF) -> DF:
    """DF + DF, cancellation-safe (QD-style accurate add)."""
    s1, s2 = two_sum(x.hi, y.hi)
    t1, t2 = two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = two_sum(s1, s2)
    s2 = s2 + t2
    return renorm(s1, s2)
