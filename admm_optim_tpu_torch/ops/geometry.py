"""Batched affine-simplex geometry (port of admm_optim_tpu/ops/geometry.py).

Per-element Jacobians, inverses, volumes and P1 basis gradients as dense
batched tensor ops, element (or lattice) axes LAST, same layouts as the JAX
package: per-element tensors ``(d, d, ...)``, basis gradients
``(nl, d, ...)``, coordinates enter as ``(V, d)``.
"""
from __future__ import annotations

import math

import torch


def sdet(J):
    """det of (d, d, ...) stacked matrices."""
    d = J.shape[0]
    if d == 2:
        return J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
    return (
        J[0, 0] * (J[1, 1] * J[2, 2] - J[1, 2] * J[2, 1])
        - J[0, 1] * (J[1, 0] * J[2, 2] - J[1, 2] * J[2, 0])
        + J[0, 2] * (J[1, 0] * J[2, 1] - J[1, 1] * J[2, 0])
    )


def sinv(J, det):
    """inverse of (d, d, ...) stacked matrices given det."""
    d = J.shape[0]
    if d == 2:
        a, b, c, dd = J[0, 0], J[0, 1], J[1, 0], J[1, 1]
        adj = torch.stack([torch.stack([dd, -b]), torch.stack([-c, a])])
        return adj / det

    def cof(i1, i2, j1, j2):
        return J[i1, j1] * J[i2, j2] - J[i1, j2] * J[i2, j1]

    adj = torch.stack(
        [
            torch.stack([cof(1, 2, 1, 2), -cof(0, 2, 1, 2), cof(0, 1, 1, 2)]),
            torch.stack([-cof(1, 2, 0, 2), cof(0, 2, 0, 2), -cof(0, 1, 0, 2)]),
            torch.stack([cof(1, 2, 0, 1), -cof(0, 2, 0, 1), cof(0, 1, 0, 1)]),
        ]
    )
    return adj / det


def gather_elem(coords, elems):
    """coords (V, d), elems (E, nl) int64 -> element corners (d, nl, E)."""
    return coords.T[:, elems.T]


def elem_geometry(coords, elems):
    """-> (J (d,d,E), detJ (E,), Jinv (d,d,E), vol (E,)); detJ is SIGNED,
    vol = |detJ| / d!."""
    d = coords.shape[1]
    x = gather_elem(coords, elems)  # (d, nl, E)
    J = x[:, 1:, :] - x[:, :1, :]  # (d, d, E): J[a, b] = edge vector b, comp a
    det = sdet(J)
    Jinv = sinv(J, det)
    vol = det.abs() / math.factorial(d)
    return J, det, Jinv, vol


def corner_geometry(x):
    """elem_geometry from explicit corner positions x (d, nl, ...) in any
    trailing batch layout (the patch-stencil assembly's lattice slices)."""
    d = x.shape[0]
    J = x[:, 1:] - x[:, :1]
    det = sdet(J)
    Jinv = sinv(J, det)
    vol = det.abs() / math.factorial(d)
    return J, det, Jinv, vol


def p1_phys_grads(Jinv):
    """Physical P1 basis gradients (nl, d, ...): rows of [-1; I] @ Jinv."""
    return torch.cat([-Jinv.sum(0, keepdim=True), Jinv], dim=0)
