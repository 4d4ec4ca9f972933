"""The port's matrix-free NS operators and the P1/P1 velocity (vorder=1)
against the JAX package's, float64 on the CPU at 2D refs=1: the jvp and
the vjp of ns_residual, the residual's coupling B^T / B (_bt_coupling), the
block-diagonal default preconditioner, the P1/P1 velocity cycle's data
(p2_iso=False) on both backends and the block-triangular preconditioner
without an assembled Jacobian, all to 1e-12; the fixed-order segment sums
of ns_residual; the Newton solve, drag, adjoint and J' of the NS path,
matrix-free and P1/P1 with stab 0.05, against the JAX package's host-stepped
run (tests/goldens/e2e_variants.npz), and the P1/P1 drag against its
monolithic newton_solve and within 25% of the P2 drag (tests/test_ns.py's
criterion)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_variants_golden as V
from admm_optim_tpu.models import obstacle as jobstacle
from admm_optim_tpu.ops import navier_stokes as jnsops
from admm_optim_tpu.ops.p1space import P1VectorSpace as JSpace
from admm_optim_tpu.solvers import ns_solver as jns
from admm_optim_tpu_torch import convert, ns_run
from admm_optim_tpu_torch.ops import navier_stokes as nsops
from admm_optim_tpu_torch.solvers import ns_solver as tns
from torch_obstacle_golden import VARIANTS_GOLD

torch.set_num_threads(1)

VISC = V.NS_VISC


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_problem(case):
    kw = dict(V.NS_CASES[case])
    return jobstacle.ProblemConfig(**kw)


@pytest.fixture(scope="module", params=["ns_mf", "ns_p1"])
def case(request):
    """Both packages at one perturbed cold-start state: the JAX
    ObstacleShapeOpt of the case, the port's ns_run context built as
    ObstacleShapeOpt builds it."""
    jcfg = _jax_problem(request.param)
    prob = jobstacle.ObstacleShapeOpt(jcfg)
    assert not prob.use_ns_jac and prob.use_patch_ns
    ctx = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=2, stab=jcfg.stab, vorder=jcfg.vorder,
                       ns_assembled_jac=jcfg.ns_assembled_jac)
    assert not ctx.assembled
    X = prob.X0
    rng = np.random.default_rng(17)
    s = np.asarray(prob.initial_state(X)) + 0.1 * rng.normal(size=ctx.n_state)
    return dict(name=request.param, prob=prob, ctx=ctx, X=X, s=s, rng=rng, stab=jcfg.stab)


def test_residual_jvp_and_vjp_match_jax(case):
    """The matrix-free Newton matvec (torch.func.jvp) and the adjoint's
    transpose (one torch.func.vjp, re-applied) against jax.jvp / jax.vjp."""
    ctx, prob, rng = case["ctx"], case["prob"], case["rng"]
    s, x = case["s"], rng.normal(size=ctx.n_state)

    def R_t(ss):
        return nsops.ns_residual(ctx.space, ctx.coords, ss, VISC, case["stab"])

    def R_j(ss):
        return jnsops.ns_residual(prob.ns_space, case["X"], ss, VISC, case["stab"])

    assert _rel(R_t(torch.from_numpy(s)), R_j(jnp.asarray(s))) < 1e-12
    jv = torch.func.jvp(R_t, (torch.from_numpy(s),), (torch.from_numpy(x),))[1]
    assert _rel(jv, jax.jvp(R_j, (jnp.asarray(s),), (jnp.asarray(x),))[1]) < 1e-12
    Jt = tns.residual_vjp(ctx.space, ctx.coords, torch.from_numpy(s), VISC, case["stab"])
    _, vjp_j = jax.vjp(R_j, jnp.asarray(s))
    for _ in range(2):  # the closure is re-applied
        y = rng.normal(size=ctx.n_state)
        assert _rel(Jt(torch.from_numpy(y)), vjp_j(jnp.asarray(y))[0]) < 1e-12


def test_bt_coupling_and_diag_preconditioner_match_jax(case):
    ctx, prob, rng = case["ctx"], case["prob"], case["rng"]
    X, stab = case["X"], case["stab"]
    bt_t, b_t = tns._bt_coupling(ctx.space, ctx.coords, VISC, stab, ctx.coords)
    bt_j, b_j = jns._bt_coupling(prob.ns_space, X, VISC, stab, X)
    zp = rng.normal(size=ctx.space.n_pressure)
    zv = rng.normal(size=(ctx.space.dim, ctx.space.n_vel))
    assert _rel(bt_t(torch.from_numpy(zp)), bt_j(jnp.asarray(zp))) < 1e-12
    assert _rel(b_t(torch.from_numpy(zv)), b_j(jnp.asarray(zv))) < 1e-12
    r = rng.normal(size=ctx.n_state)
    Md = nsops.diag_preconditioner(ctx.space, ctx.coords, VISC)
    assert _rel(Md(torch.from_numpy(r)), jnsops.diag_preconditioner(prob.ns_space, X, VISC)(jnp.asarray(r))) < 1e-12
    assert _rel(nsops.pressure_mass_lumped(ctx.space, ctx.coords, VISC),
                jnsops.pressure_mass_lumped(prob.ns_space, X, VISC)) < 1e-12


def test_matrix_free_preconditioner_matches_jax(case):
    """The velocity cycle's data (P1/P1: p2_iso=False, on the NS level's own
    lattice) and the block-triangular M with the residual's B^T, as the JAX
    package's _M_fn composes it without an assembled Jacobian; ns_gmg_M's
    own fallback (coords and visc, no bt_fn) gives the same."""
    ctx, prob, rng = case["ctx"], case["prob"], case["rng"]
    X, s = case["X"], case["s"]
    pre_j, pdiag_j, _ = prob._ns_pre(X, s=jnp.asarray(s), nu=VISC)
    m_t = ctx.pre_full(ctx.coords, torch.from_numpy(s), VISC)
    pre_t, pdiag_t = m_t[0], m_t[1]
    assert callable(m_t[-1])  # the residual's B^T stands where the Jacobian would
    assert len(pre_t.W) == len(pre_j.W)
    for l in range(len(pre_t.W)):
        assert _rel(pre_t.W[l], pre_j.W[l]) < 1e-12
    assert _rel(pre_t.base_inv, pre_j.base_inv) < 1e-12
    assert _rel(pdiag_t, pdiag_j) < 1e-12
    M_j = jax.jit(jns.ns_gmg_M(
        prob.ns_space, prob.pre_struct, pre_j, pdiag_j,
        vel_M=jns.patch_velocity_M(prob.pre_ps, prob._pre_struct_p, pre_j),
        coords=X, visc=VISC, stab=case["stab"],
    ))
    r = rng.normal(size=ctx.n_state)
    want = M_j(jnp.asarray(r))
    assert _rel(ctx.M_fn(torch.from_numpy(r), *m_t), want) < 1e-12
    vel_M = tns.patch_velocity_M(ctx.pre_ps, ctx.pre_struct, pre_t)
    M_t = tns.ns_gmg_M(ctx.space, pdiag_t, vel_M, coords=ctx.coords, visc=VISC, stab=case["stab"])
    assert _rel(M_t(torch.from_numpy(r)), want) < 1e-12


def test_p1_velocity_data_on_the_global_backend_matches_jax():
    """ns_gmg_precond_data with p2_iso=False: the conv-diff hierarchy of the
    P1 space over the NS levels at the mesh's own coordinates."""
    ctx = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=2, backend="global", vorder=1, stab=V.P1_STAB)
    assert not ctx.assembled and ctx.ell is None
    h = ctx.hier
    from admm_optim_tpu.core import geomgen as jgeomgen
    from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy, refine as jrefine

    levels = [jgeomgen.channel_2d(diag="alt")]
    levels.append(jrefine(levels[-1]))
    jh = JHierarchy(levels)
    np.testing.assert_array_equal(jh.fine.elems, h.fine.elems)
    jspace = jnsops.NSSpace.build(jh.fine, vorder=1)
    pre_space = JSpace.build(jh, dirichlet=("inlet", "wall", "obstacle_surface"))
    pre_struct = dataclasses.replace(pre_space.mg_structure(pre_smooth=2, post_smooth=2), smoother="jacobi")
    s = np.random.default_rng(4).normal(size=ctx.n_state) * 0.3
    X = jnp.asarray(jh.fine.coords)
    pre_j, pdiag_j = jns.ns_gmg_precond_data(jspace, pre_space, pre_struct, X, VISC, s=jnp.asarray(s),
                                            p2_iso=False, with_transpose=True)
    pre_t, pdiag_t = tns.ns_gmg_precond_data(ctx.space, ctx.pre_space, ctx.pre_struct, ctx.coords, VISC,
                                             torch.from_numpy(s), with_transpose=True, p2_iso=False)
    for l in range(len(pre_space.patterns)):
        assert _rel(pre_t.vals[l], pre_j.vals[l]) < 1e-12
        assert _rel(pre_t.vals_t[l], pre_j.vals_t[l]) < 1e-12
    assert _rel(pdiag_t, pdiag_j) < 1e-12


@pytest.mark.parametrize("refs,dim", [(1, 2), (0, 3)], ids=["2d_refs1", "3d_refs0"])
def test_residual_segment_sums(refs, dim):
    """ns_residual's plans: the fixed-order gather-sum (the GPU's form)
    equals index_add_ in index order (the CPU's, what ns_residual gave
    before) to rounding, and index_sum is exactly index_add_."""
    ctx = ns_run.build(refs, "cpu", torch.float64, visc=VISC, dim=dim, ns_assembled_jac="off")
    sp = ctx.space
    vplan, pplan = sp.plans()
    rng = np.random.default_rng(dim)
    for plan, ids in ((vplan, sp.vel_dofs.T.reshape(-1)), (pplan, sp.elems.T.reshape(-1))):
        src = torch.from_numpy(rng.normal(size=(sp.dim, len(ids))))
        ref = torch.zeros((sp.dim, plan.n_out), dtype=torch.float64).index_add_(1, torch.from_numpy(ids), src)
        assert torch.equal(plan.index_sum(src), ref)
        assert float((plan.gather_sum(src) - ref).abs().max()) <= 1e-14 * float(ref.abs().max())
        assert torch.equal(plan(src), ref)  # CPU tensors take index_sum


@pytest.fixture(scope="module")
def ns_runs():
    """The port's NS path for both cases: ns_run.run at visc 0.16 from the
    cold start (Newton, drag, adjoint, J')."""
    out = {}
    for name in V.NS_CASES:
        jcfg = convert.problem_config(_jax_problem(name))
        ctx = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=2, stab=jcfg.stab, vorder=jcfg.vorder,
                           ns_assembled_jac=jcfg.ns_assembled_jac)
        out[name] = (ctx, ns_run.run(ctx))
    return out


# Newton iterations whose linear counts are held: past the third the linear
# residuals land at the inexact-Newton targets, and the last bits of the
# jvp (another summation order than XLA's) decide whether a 50-step chunk
# reaches them: one thread gave the matrix-free run 7 Newton iterations
# ([50, 66, 66, 66, 66, 66, 16]) against the JAX run's 6, and the P1/P1
# run [50, 66, 66, 66, 116, 16] against [50, 66, 66, 116, 66, 16], both at
# the same drag to 4e-10
STABLE_NEWTON = 3


@pytest.mark.parametrize("name", list(V.NS_CASES))
def test_ns_path_matches_jax(ns_runs, name):
    """The linear counts of the stable prefix, converged, drag to 1e-8, the
    adjoint's count and J' against the JAX package's host-stepped run."""
    ctx, out = ns_runs[name]
    g = {k: VARIANTS_GOLD[f"{name}_{k}"] for k in ("newton_iters", "lin_iters", "drag", "adj_iters", "jprime",
                                                 "converged")}
    assert out.newton.converged and bool(g["converged"])
    assert list(out.newton.lin_iters[:STABLE_NEWTON]) == g["lin_iters"][:STABLE_NEWTON].tolist()
    assert abs(out.drag - float(g["drag"])) <= 1e-8 * abs(float(g["drag"]))
    assert out.adjoint.iters == int(g["adj_iters"]) and out.adjoint.exit == "target"
    assert _rel(out.jprime, g["jprime"]) < 1e-6


def test_p1p1_drag_matches_monolithic_newton_and_p2(ns_runs):
    """The P1/P1 state against the JAX package's monolithic newton_solve
    (its default block-diagonal preconditioner): drag to 1e-8; and the
    tests/test_ns.py criterion, within 25% of the P2 drag."""
    _, p1 = ns_runs["ns_p1"]
    _, p2 = ns_runs["ns_mf"]
    assert bool(VARIANTS_GOLD["p1_mono_converged"])
    mono = float(VARIANTS_GOLD["p1_mono_drag"])
    assert abs(p1.drag - mono) <= 1e-8 * mono
    assert abs(p1.drag - p2.drag) <= 0.25 * p2.drag


def test_default_diag_newton_matches_monolithic_newton():
    """newton_solve_stepped with no preconditioner and no Jacobian (the
    block-diagonal default, the jvp) on the P1/P1 space with stab 0.05:
    converged, and the drag of the JAX package's monolithic newton_solve
    from the same start to 1e-8."""
    jcfg = convert.problem_config(_jax_problem("ns_p1"))
    ctx = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=2, stab=jcfg.stab, vorder=1)
    cfg = tns.NewtonConfig()
    res = tns.newton_solve_stepped(ctx.space, ctx.coords, ns_run.initial_state(ctx), VISC, jcfg.stab, cfg)
    assert res.converged
    mono = float(VARIANTS_GOLD["p1_mono_drag"])
    assert abs(float(nsops.drag(ctx.space, ctx.coords, res.s, VISC)) - mono) <= 1e-8 * mono
