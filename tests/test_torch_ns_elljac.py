"""The port's assembled per-element NS Jacobian (ops/ns_elljac.py) and the
global backend's block preconditioner against the JAX package's, float64:
the blocks (the port keeps them element-first, W (E, nloc, nloc)), J x,
J^T x, the stored B^T and its transpose B, at 2D refs=1 (alternating
diagonals) and 3D refs=0 from one numpy seed, to 1e-12; the ELL J x equal
to the lattice Jacobian's (ops/ns_patchjac.py) on a brick mesh; the blocks
bitwise equal at any JAC_ELEM_CHUNK; and the adjoint's preconditioner,
transpose_M of the ELL block-triangular M (ns_run's global NSContext),
equal to the JAX package's jax.vjp transpose, with no index_add or scatter
in the graph it replays."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy, refine as jrefine
from admm_optim_tpu.ops import navier_stokes as jnsops
from admm_optim_tpu.ops import ns_elljac as jell
from admm_optim_tpu.ops.p1space import P1VectorSpace as JSpace
from admm_optim_tpu.solvers import ns_solver as jns
from admm_optim_tpu_torch import ns_run
from admm_optim_tpu_torch.ops import ns_elljac as ell
from admm_optim_tpu_torch.solvers.ns_solver import transpose_M

torch.set_num_threads(1)

VISC = 0.05


def _state(space, rng, scale=0.3):
    return np.concatenate([rng.normal(size=space.dim * space.n_vel) * scale,
                           rng.normal(size=space.n_pressure) * scale])


@pytest.fixture(scope="module", params=[(2, 1), (3, 0)], ids=["2d_refs1", "3d_refs0"])
def case(request):
    dim, refs = request.param
    ctx = ns_run.build(refs, "cpu", torch.float64, visc=VISC, dim=dim, backend="global")
    levels = [jgeomgen.channel_2d(diag="alt") if dim == 2 else jgeomgen.channel_3d()]
    for _ in range(refs):
        levels.append(jrefine(levels[-1]))
    jh = JHierarchy(levels)
    jspace = jnsops.NSSpace.build(jh.fine, vorder=2)
    jw = jell.build_wiring(jspace)
    rng = np.random.default_rng(5 + dim)
    s0 = _state(ctx.space, rng)
    X = jh.fine.coords
    W_j = jell.make_assemble_fn(jspace, jw)(jnp.asarray(X), jnp.asarray(s0), VISC)
    W = ctx.jac(ctx.coords, torch.as_tensor(s0), VISC)
    return dict(ctx=ctx, jh=jh, jspace=jspace, jw=jw, rng=rng, s0=s0, W_j=W_j, W=W)


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_wiring_and_blocks(case):
    w, jw = case["ctx"].ell, case["jw"]
    assert np.array_equal(w.loc_idx, jw.loc_idx) and np.array_equal(w.fixed_state, jw.fixed_state)
    assert ell.jac_memory_bytes(w, 8) == jell.jac_memory_bytes(jw, 8)
    _close(case["W"].permute(1, 2, 0), case["W_j"])


def test_matvecs_and_coupling(case):
    ctx, jspace, jw, rng = case["ctx"], case["jspace"], case["jw"], case["rng"]
    x = _state(ctx.space, rng, 1.0)
    jv, jtv = jell.make_matvec_fns(jspace, jw)
    _close(ctx.jv(torch.as_tensor(x), case["W"]), jv(jnp.asarray(x), case["W_j"]))
    _close(ctx.jtv(torch.as_tensor(x), case["W"]), jtv(jnp.asarray(x), case["W_j"]))
    zp = rng.normal(size=ctx.space.n_pressure)
    zv = rng.normal(size=(ctx.space.dim, ctx.space.n_vel))
    bt, b = ell.make_bt_fn(ctx.space, ctx.ell), ell.make_b_fn(ctx.space, ctx.ell)
    y = bt(torch.as_tensor(zp), case["W"])
    _close(y, jell.make_bt_fn(jspace, jw)(jnp.asarray(zp), case["W_j"]))
    _close(b(torch.as_tensor(zv), case["W"]), jell.make_b_fn(jspace, jw)(jnp.asarray(zv), case["W_j"]))
    lhs = float(torch.sum(y * torch.as_tensor(zv)))
    rhs = float(torch.dot(torch.as_tensor(zp), b(torch.as_tensor(zv), case["W"])))
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


def test_blocks_bitwise_equal_across_chunks(case, monkeypatch):
    ctx = case["ctx"]
    s0 = torch.as_tensor(case["s0"])
    for chunk in (7, 64, ctx.ell.E):
        monkeypatch.setattr(ell, "JAC_ELEM_CHUNK", chunk)
        assert torch.equal(ctx.jac(ctx.coords, s0, VISC), case["W"]), chunk


def test_transposed_preconditioner_equals_the_jax_vjp(case):
    ctx, rng = case["ctx"], case["rng"]
    s0 = torch.as_tensor(case["s0"])
    m_args = ctx.pre_full(ctx.coords, s0, VISC)
    M = lambda r: ctx.M_fn(r, *m_args)  # noqa: E731
    MT = transpose_M(M, ctx.n_state, torch.float64, "cpu")
    x0 = torch.zeros(ctx.n_state, dtype=torch.float64, requires_grad=True)
    with torch.enable_grad():
        y = M(x0)
    names, stack = set(), [y.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and type(node).__name__ not in names:
            names.add(type(node).__name__)
            stack.extend(f for f, _ in node.next_functions)
    assert not any("Index" in n or "Scatter" in n for n in names), names
    # the JAX package's block preconditioner on the same state and its vjp
    jh, jspace = case["jh"], case["jspace"]
    ns_dir = ("inlet", "wall", "obstacle_surface")
    pre_space = JSpace.build(JHierarchy(jh.levels + [jrefine(jh.fine)]), dirichlet=ns_dir)
    pre_struct = dataclasses.replace(pre_space.mg_structure(pre_smooth=2, post_smooth=2), smoother="jacobi")
    X = jnp.asarray(jh.fine.coords)
    pre_data, pdiag = jns.ns_gmg_precond_data(jspace, pre_space, pre_struct, X, VISC, s=jnp.asarray(case["s0"]),
                                             with_transpose=True)
    jbt = jell.make_bt_fn(jspace, case["jw"])
    jM = jns.ns_gmg_M(jspace, pre_struct, pre_data, pdiag, bt_fn=lambda zp: jbt(zp, case["W_j"]))
    jMT = jns.transpose_M(jM, ctx.n_state, jnp.float64)
    r = rng.normal(size=ctx.n_state)
    _close(M(torch.as_tensor(r)), jM(jnp.asarray(r)))
    _close(MT(torch.as_tensor(r)), jMT(jnp.asarray(r)))
    z = rng.normal(size=ctx.n_state)
    lhs = float(torch.dot(M(torch.as_tensor(r)), torch.as_tensor(z)))
    assert abs(lhs - float(torch.dot(torch.as_tensor(r), MT(torch.as_tensor(z))))) <= 1e-12 * abs(lhs)


def test_ell_and_lattice_jacobians_agree():
    """On the 2D brick mesh (fixed diagonals) both backends number the
    packed state alike: J x of the per-element and of the lattice Jacobian."""
    cp = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=2)
    cg = ns_run.build(1, "cpu", torch.float64, visc=VISC, hier=cp.hier, backend="global")
    rng = np.random.default_rng(9)
    s0 = torch.as_tensor(_state(cp.space, rng))
    x = torch.as_tensor(_state(cp.space, rng, 1.0))
    Wp, Wg = cp.jac(cp.coords, s0, VISC), cg.jac(cg.coords, s0, VISC)
    for a, b in ((cp.jv(x, Wp), cg.jv(x, Wg)), (cp.jtv(x, Wp), cg.jtv(x, Wg))):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
