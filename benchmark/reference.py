"""The plain float64 reference of the deformation operator, matrix-free and
chunked over elements, and the true residual that judges a solve.

    a(u, w) = c_eps eps(u):eps(w) + c_grad grad(u):grad(w) + c_mass u.w

on P1 tetrahedra (|det J| volumes), restricted to the free vertices: the
Dirichlet rows and columns are left out, as the configuration's solve
states.  Vertex fields are (3, V).  This module imports numpy and torch
only: nothing of the program, whose answers it judges.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 21  # elements a block: ~1.5 GB of float64 temporaries


class Mesh:
    """Fine-mesh coordinates, elements and free mask on a device."""

    def __init__(self, coords: np.ndarray, elems: np.ndarray, free: np.ndarray, device):
        self.coords = torch.as_tensor(coords, dtype=torch.float64, device=device)
        self.elems = torch.as_tensor(elems, device=device)
        self.free = torch.as_tensor(free, dtype=torch.float64, device=device)

    @property
    def n_vertices(self) -> int:
        return self.coords.shape[0]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def basis(coords: torch.Tensor, elems: torch.Tensor):
    """(grads (n, 4, 3) of the barycentric coordinates, volumes (n,)) of
    the elements elems (n, 4)."""
    x = coords[elems]  # (n, 4, 3)
    r0, r1, r2 = x[:, 1] - x[:, 0], x[:, 2] - x[:, 0], x[:, 3] - x[:, 0]
    c12, c20, c01 = _cross(r1, r2), _cross(r2, r0), _cross(r0, r1)
    det = (r0 * c12).sum(dim=1)
    g123 = torch.stack([c12, c20, c01], dim=1) / det[:, None, None]
    g = torch.cat([-g123.sum(dim=1, keepdim=True), g123], dim=1)
    return g, det.abs() / 6.0


def apply(mesh: Mesh, x: torch.Tensor, c_eps: float, c_grad: float, c_mass: float,
          chunk: int = CHUNK) -> torch.Tensor:
    """y = A x for a (3, V) float64 field, element block by element block."""
    y = torch.zeros_like(x)
    for s in range(0, mesh.elems.shape[0], chunk):
        e = mesh.elems[s:s + chunk].long()
        g, vol = basis(mesh.coords, e)
        xe = x[:, e].permute(1, 0, 2)  # (n, c, j)
        G = torch.einsum("ncj,njk->nck", xe, g)  # G[c, k] = d_k u_c
        t = (c_grad + 0.5 * c_eps) * torch.einsum("nik,nck->nci", g, G)
        t += (0.5 * c_eps) * torch.einsum("nid,ndc->nci", g, G)
        t += (c_mass / 20.0) * (xe + xe.sum(dim=2, keepdim=True))
        t *= vol[:, None, None]
        y.index_add_(1, e.reshape(-1), t.permute(1, 0, 2).reshape(3, -1))
    return y


def apply_free(mesh: Mesh, x: torch.Tensor, coeffs) -> torch.Tensor:
    """The operator on the free subspace: free * A (free * x)."""
    return apply(mesh, x * mesh.free, *coeffs) * mesh.free


def rel_residual(mesh: Mesh, coeffs, b: torch.Tensor, x: torch.Tensor) -> float:
    """||free * (b - A (free * x))|| / ||b||, all in float64."""
    b = b.to(torch.float64)
    r = b * mesh.free - apply_free(mesh, x.to(torch.float64), coeffs)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
