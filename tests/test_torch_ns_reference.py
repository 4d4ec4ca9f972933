"""The plain float64 NS reference of the r2-ns-newton cell
(benchmark/ns_reference.py) against the port's residual and drag, its node
layout against the port's, the pool's deformations and the cell's byte
count by hand, on the 3D channel at refs=0 (360 vertices, 1,938 edges,
1,344 tets, 7,254 NS unknowns) in float64 on the CPU.  The cell's driver
end to end: tests/test_torch_ns_resolve.py."""

import numpy as np
import pytest
import torch

from admm_optim_tpu_torch.core.mesh import Hierarchy, MeshLevel
from admm_optim_tpu_torch.core.quadrature import simplex_rule
from admm_optim_tpu_torch.ops import navier_stokes as nsops
from benchmark import cost_ns, harness, meshgen
from benchmark import ns_reference as nr
from benchmark.drivers import ns_resolve

torch.set_num_threads(1)

CONFIG = harness.load_json(harness.ROOT / "tests" / "data" / "channel3d-r0-ns.json")
TRAFFIC = harness.load_json(harness.ROOT / "traffic" / "ns-resolve.json")


@pytest.fixture(scope="module")
def mesh():
    levels, _ = meshgen.load_levels(0, log=lambda *a: None)
    fine = levels[-1]
    space = nsops.NSSpace.build(Hierarchy([MeshLevel(dim=3, **lvl) for lvl in levels]).fine)
    X = torch.as_tensor(fine["coords"], dtype=torch.float64)
    Xs = X[None] + ns_resolve.deformations(5, TRAFFIC["pool"], X, (0.0, 0.0, 0.0))
    return fine, space, nr.Mesh(fine, "cpu"), [X] + list(Xs[:2])


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("degree", (5, 3))
def test_quadrature_is_the_ports(degree):
    """The rules written out in the reference are the port's
    Grundmann-Moller rules, point for point."""
    pts, w = simplex_rule(3, degree)
    P, W = nr.rule(nr.QUAD5 if degree == 5 else nr.QUAD3)
    order = lambda a: np.lexsort(a.T)  # noqa: E731
    np.testing.assert_allclose(P[order(P)], pts[order(pts)], rtol=0, atol=1e-15)
    np.testing.assert_allclose(W[order(P)], w[order(pts)], rtol=0, atol=1e-15)


@pytest.mark.parametrize("k", range(3), ids=["undeformed", "bump0", "bump1"])
def test_residual_and_drag_are_the_ports(mesh, k):
    """ns_residual and drag of the port against the reference, at seeded
    random states (the inlet data plus noise, so the Dirichlet rows read
    v - g with g nonzero) on the undeformed and two deformed meshes: equal
    to 1e-12 relative in float64."""
    _, space, ref, Xs = mesh
    X = Xs[k]
    gen = torch.Generator().manual_seed(100 + k)
    s = ref.cold_state(X) + 0.3 * torch.randn(ref.n_state, generator=gen, dtype=torch.float64)
    for visc in (0.02, 0.16):
        assert _rel(nr.residual(ref, X, s, visc), nsops.ns_residual(space, X, s, visc)) <= 1e-12
        j = nr.drag(ref, X, s, visc)
        assert abs(j - float(nsops.drag(space, X, s, visc))) <= 1e-12 * abs(j)
    assert _rel(ref.cold_state(X), torch.cat([nsops.inlet_values(space, X).reshape(-1),
                                              X.new_zeros(space.n_pressure)])) == 0.0


def test_cold_state_residual_reads_one(mesh):
    _, _, ref, Xs = mesh
    got = nr.readings(ref, 0.02, [(Xs[1], ref.cold_state(Xs[1]), 1.0)])
    assert got["ns_res_rel"] == 1.0


def test_node_layout_is_checked_by_coordinates(mesh):
    """The port's velocity nodes are the reference's; a layout with two
    edges swapped fails loudly."""
    _, space, ref, Xs = mesh
    for X in Xs:
        nr.check_layout(ref, X, nsops.vel_dof_coords(space, X))
    bad = nsops.vel_dof_coords(space, Xs[0]).clone()
    V = ref.n_vertices
    bad[:, [V, V + 1]] = bad[:, [V + 1, V]]
    with pytest.raises(RuntimeError, match="edge midpoints"):
        nr.check_layout(ref, Xs[0], bad)


def test_pool_vanishes_on_the_deformation_dirichlet_set(mesh):
    fine, _, _, Xs = mesh
    zero = meshgen.dirichlet_mask(fine, TRAFFIC["pool"]["zero_on"])
    d = Xs[1] - Xs[0]
    assert float(d[zero].abs().max()) == 0.0 and float(d.abs().max()) > 1e-3
    # |d| <= |M|_F phi(r) r, whose largest value is at r = R / sqrt(5)
    pool = TRAFFIC["pool"]
    assert float(d.norm(dim=1).max()) <= pool["frobenius"] * 16 / 25 * pool["radius"] / np.sqrt(5)


def test_cost_by_hand_at_refs0():
    """At refs=0 the pressure lattice is 2^3 x 224 (1 cell a patch), the
    velocity lattice 3^3 x 224 over the 360-vertex base."""
    cells, vel, p = 224, 3 * 27 * 224, 8 * 224
    jac = 6 * 34 * 34 * cells * 4 + 2 * (vel + p) * 4
    vcycle = 4 * (15 * 9 * 27 * 224 * 4 + 2 * 3 * 27 * 224 * 4) + 1080 * 1080 * 4 + 2 * 1080 * 4
    bt = 6 * 30 * 4 * cells * 4 + (vel + p) * 4
    assert cost_ns.jac_apply_bytes(CONFIG) == jac
    assert cost_ns.vcycle_bytes(CONFIG) == vcycle
    assert cost_ns.bt_apply_bytes(CONFIG) == bt
    assert cost_ns.request_bytes(CONFIG, 4, 164) == 168 * jac + (164 - 64) * (vcycle + bt)
    assert cost_ns.request_bytes(CONFIG, 4, 50) == 54 * jac
