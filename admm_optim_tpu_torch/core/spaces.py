"""Reference finite elements on the unit simplex: P1, P2, piecewise constant.

TPU-native equivalent of UG4's ``ApproximationSpace`` function spaces
(reference 2d_admm.lua:224-225 Lagrange 1/2, 2d_admm.lua:337
Piecewise-Constant).  Shape functions and gradients are tabulated at
quadrature points as dense numpy tables; all runtime work is batched einsum
against these tables.

DoF layout conventions (fields are arrays, not opaque GridFunctions):
 * P1 field: (V, C) - one row per mesh vertex.
 * P2 field: (V + Ne, C) - vertices then edge midpoints.
 * PC field: (E, C) - one row per element.
"""
from __future__ import annotations

import numpy as np

from .mesh import MeshLevel, TET_EDGES, TRI_EDGES
from .quadrature import simplex_rule


def p1_tab(dim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """P1 basis values (nq, d+1) and reference gradients (nq, d+1, d)."""
    bary, _ = simplex_rule(dim, degree)
    vals = bary  # barycentric coordinates ARE the P1 basis
    nq = len(bary)
    g = np.zeros((dim + 1, dim))
    g[0] = -1.0
    g[1:] = np.eye(dim)
    grads = np.broadcast_to(g, (nq, dim + 1, dim)).copy()
    return vals, grads


def p2_tab(dim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """P2 basis: d+1 vertex functions then one per local edge (combinations
    order, matching MeshLevel.elem_edges)."""
    bary, _ = simplex_rule(dim, degree)
    nq = len(bary)
    loc_edges = TET_EDGES if dim == 3 else TRI_EDGES
    nb = (dim + 1) + len(loc_edges)
    vals = np.zeros((nq, nb))
    grads = np.zeros((nq, nb, dim))
    # gradient of barycentric coords wrt reference coords
    dl = np.zeros((dim + 1, dim))
    dl[0] = -1.0
    dl[1:] = np.eye(dim)
    for i in range(dim + 1):
        li = bary[:, i]
        vals[:, i] = li * (2.0 * li - 1.0)
        grads[:, i, :] = ((4.0 * li - 1.0)[:, None]) * dl[i]
    for k, (a, b) in enumerate(loc_edges):
        j = dim + 1 + k
        vals[:, j] = 4.0 * bary[:, a] * bary[:, b]
        grads[:, j, :] = 4.0 * (bary[:, a][:, None] * dl[b] + bary[:, b][:, None] * dl[a])
    return vals, grads


def p2_elem_dofs(lvl: MeshLevel) -> np.ndarray:
    """(E, nb) global P2 DoF indices per element: vertices then V+edge."""
    return np.concatenate([lvl.elems, lvl.elem_edges + lvl.num_vertices], axis=1).astype(
        np.int32
    )


def p2_num_dofs(lvl: MeshLevel) -> int:
    return lvl.num_vertices + len(lvl.edges)


def p2_dof_coords(lvl: MeshLevel) -> np.ndarray:
    """(Vp2, dim) physical positions of P2 DoFs (vertices + edge midpoints)."""
    return np.concatenate([lvl.coords, lvl.coords[lvl.edges].mean(axis=1)], axis=0)


def p2_vertex_mask_to_dofs(lvl: MeshLevel, vmask: np.ndarray, emask: np.ndarray) -> np.ndarray:
    """Combine a vertex mask (V,) and an edge mask (Ne,) into a P2 DoF mask."""
    return np.concatenate([vmask, emask]).astype(bool)
