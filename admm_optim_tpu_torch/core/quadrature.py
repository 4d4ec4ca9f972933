"""Simplex quadrature via Grundmann-Moller rules (any odd degree, any dim).

Replaces UG4's per-order Gauss rules selected by the ``quad_order`` arguments
in the reference drivers (e.g. ``Drag(...,3)`` 2d_admm.lua:768,
``VolumeDefect(...,4,...)`` 2d_admm.lua:773, ``quad_order(1)`` 3d_admm.lua:393).

Points are returned in barycentric coordinates (nq, dim+1); weights sum to 1
so that ``integral = |simplex| * sum(w * f(points))``.
"""
from __future__ import annotations

import itertools
import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def simplex_rule(dim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Grundmann-Moller rule exact to the given (odd) polynomial degree.

    Returns (points_barycentric (nq, dim+1), weights (nq,)) with sum(w) == 1.
    """
    d = degree if degree % 2 == 1 else degree + 1  # GM rules have odd degree
    s = (d - 1) // 2
    n = dim
    pts, wts = [], []
    for i in range(s + 1):
        denom = d + n - 2 * i
        w = (
            (-1.0) ** i
            * 2.0 ** (-2 * s)
            * float(denom) ** d
            / (math.factorial(i) * math.factorial(d + n - i))
        )
        # all k in Z_{>=0}^{n+1} with |k| = s - i
        for k in _compositions(s - i, n + 1):
            pts.append([(2.0 * kj + 1.0) / denom for kj in k])
            wts.append(w)
    pts_arr = np.asarray(pts, dtype=np.float64)
    w_arr = np.asarray(wts, dtype=np.float64)
    # GM weights integrate over the unit simplex of volume 1/n!; normalize so
    # weights sum to one (verified exact in tests against monomials)
    w_arr = w_arr / w_arr.sum()
    return pts_arr, w_arr


def _compositions(total: int, parts: int):
    """All tuples of `parts` nonnegative ints summing to `total`."""
    if parts == 1:
        yield (total,)
        return
    for first in range(total + 1):
        for rest in _compositions(total - first, parts - 1):
            yield (first,) + rest


def rule_points_ref(dim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature in reference coordinates xi (nq, dim): bary[1:]."""
    bary, w = simplex_rule(dim, degree)
    return bary[:, 1:], w
