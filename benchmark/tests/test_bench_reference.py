"""The float64 reference at refs 0 and 1: its operator is the
configuration's bilinear form, matrix-free and chunked, and its residual
judges a dense float64 solve as exact."""
import numpy as np
import pytest
import torch

from admm_optim_tpu_torch.ops.deformation import deformation_elem_mats
from benchmark import meshgen, reference

COEFFS = (1.0, 1.0, 1.0)
DIRICHLET = ("inlet", "wall", "outlet")


def _mesh(refs):
    lvl = meshgen.build_levels(refs)[-1]
    free = ~meshgen.dirichlet_mask(lvl, DIRICHLET)
    return lvl, reference.Mesh(lvl["coords"], lvl["elems"], free, "cpu")


def _dense(lvl, coeffs):
    """The operator as a dense (3V, 3V) float64 matrix, component-major,
    from the port's element matrices."""
    X = torch.as_tensor(lvl["coords"])
    E = torch.as_tensor(lvl["elems"].astype(np.int64))
    A = deformation_elem_mats(X, E, *coeffs)  # (C, C, nl, nl, E)
    V = X.shape[0]
    rows = (torch.arange(3)[:, None, None, None, None] * V + E.T[None, None, :, None, :])
    cols = (torch.arange(3)[None, :, None, None, None] * V + E.T[None, None, None, :, :])
    D = torch.zeros(3 * V, 3 * V, dtype=torch.float64)
    D.index_put_((rows.expand_as(A).reshape(-1), cols.expand_as(A).reshape(-1)), A.reshape(-1), accumulate=True)
    return D


@pytest.mark.parametrize("refs", [0, 1])
@pytest.mark.parametrize("coeffs", [COEFFS, (2.0, 0.5, 3.0)])
def test_operator_matches_dense(refs, coeffs):
    lvl, mesh = _mesh(refs)
    D = _dense(lvl, coeffs)
    x = torch.randn(3, mesh.n_vertices, dtype=torch.float64, generator=torch.Generator().manual_seed(refs))
    y = reference.apply(mesh, x, *coeffs, chunk=97)  # odd blocks: the chunking adds nothing
    assert torch.allclose(y.reshape(-1), D @ x.reshape(-1), rtol=1e-12, atol=1e-12 * float(y.abs().max()))


def test_independent_of_the_port():
    """Checks that need no port: symmetry, and the mass term integrating
    to the domain's volume (20 x 6 x 6 box minus the unit cube)."""
    _, mesh = _mesh(1)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, mesh.n_vertices, dtype=torch.float64, generator=g)
    y = torch.randn(3, mesh.n_vertices, dtype=torch.float64, generator=g)
    xay = float((x * reference.apply(mesh, y, *COEFFS)).sum())
    yax = float((y * reference.apply(mesh, x, *COEFFS)).sum())
    assert abs(xay - yax) <= 1e-12 * abs(xay)
    one = torch.ones(3, mesh.n_vertices, dtype=torch.float64)
    mass = float((one * reference.apply(mesh, one, 0.0, 0.0, 1.0)).sum())
    assert abs(mass - 3 * (20 * 6 * 6 - 1)) < 1e-9
    stiff = reference.apply(mesh, one, 1.0, 1.0, 0.0)  # constants have no gradient
    assert float(stiff.abs().max()) < 1e-12


@pytest.mark.parametrize("refs", [0, 1])
def test_residual_of_a_dense_solve(refs):
    lvl, mesh = _mesh(refs)
    D = _dense(lvl, COEFFS)
    free = mesh.free.repeat(3).bool()
    b = torch.randn(3, mesh.n_vertices, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    b = b * mesh.free
    x = torch.zeros(3 * mesh.n_vertices, dtype=torch.float64)
    x[free] = torch.linalg.solve(D[free][:, free], b.reshape(-1)[free])
    x = x.reshape(3, -1)
    assert reference.rel_residual(mesh, COEFFS, b, x) < 1e-12
    assert reference.rel_residual(mesh, COEFFS, b, x * (1 + 1e-6)) > 5e-7
    assert reference.rel_residual(mesh, COEFFS, b, x.to(torch.float32)) > 1e-9
