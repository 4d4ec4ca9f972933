"""The PCD pressure block on the global (block-ELL) backend against the
JAX package's, float64 on the CPU at 2D refs=1 (alternating diagonals):
ns_pcd_spaces' inlet-Dirichlet masks and structure, ns_pcd_precond_data
(the Ap hierarchy, the baked Fp, the lumped Mp) and the block-triangular
ns_pcd_M with the ELL Schur block, with the assembled B^T and with the
residual's, to 1e-12; the exact transpose of that M replays no gather's
scatter; and one optimization step with pressure_precond "pcd" on the
global backend against tests/goldens/e2e_variants.npz ("pcdg")."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_variants_golden as V
from admm_optim_tpu.models import obstacle as jobstacle
from admm_optim_tpu.optim import admm as jadmm
from admm_optim_tpu.solvers import ns_solver as jns
from admm_optim_tpu_torch import convert, ns_run
from admm_optim_tpu_torch.models.obstacle import ObstacleShapeOpt
from admm_optim_tpu_torch.solvers import ns_solver as tns
from torch_obstacle_golden import golden, mesh_invariants, obstacle_golden

torch.set_num_threads(1)

VISC = 0.05


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def setup():
    prob = jobstacle.ObstacleShapeOpt(jobstacle.ProblemConfig(
        dim=2, num_refs=1, visc=VISC, backend="global", pressure_precond="pcd"))
    assert not prob.use_patch_ns and prob.use_ns_jac
    ctx = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=2, backend="global", pressure_precond="pcd")
    assert ctx.assembled and ctx.p_space is not None
    X = prob.X0
    rng = np.random.default_rng(23)
    s = np.asarray(prob.initial_state(X)) + 0.1 * rng.normal(size=ctx.n_state)
    return dict(prob=prob, ctx=ctx, X=X, s=s, rng=rng)


def test_pcd_spaces_match_jax(setup):
    p_space, p_struct = tns.ns_pcd_spaces(setup["ctx"].hier)
    jp, js = jns.ns_pcd_spaces(setup["prob"].hier)
    assert p_space.ncomp == 1 and p_space.dirichlet == ("inlet",)
    assert len(p_space.fixed) == len(jp.fixed)
    for a, b, pa, pb in zip(p_space.fixed, jp.fixed, p_space.patterns, jp.patterns):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(pa.cols, np.asarray(pb.cols))
    assert (p_struct.pre_smooth, p_struct.post_smooth, p_struct.smoother, p_struct.n_levels) == (
        js.pre_smooth, js.post_smooth, js.smoother, js.n_levels)


def test_pcd_precond_data_matches_jax(setup):
    ctx, prob, X, s = setup["ctx"], setup["prob"], setup["X"], setup["s"]
    ap_j, fp_j, mp_j = jns.ns_pcd_precond_data(prob.ns_space, prob.p_space, prob.p_struct, X, VISC,
                                               s=jnp.asarray(s))
    ap_t, fp_t, mp_t, fpt_t = tns.ns_pcd_precond_data(ctx.space, ctx.p_space, ctx.pcd_struct, ctx.coords, VISC,
                                                      s=torch.from_numpy(s), with_transpose=True)
    for l in range(len(ap_j.vals)):
        assert _rel(ap_t.vals[l], ap_j.vals[l]) < 1e-12
        assert _rel(ap_t.diag[l], ap_j.diag[l]) < 1e-12
        assert _rel(ap_t.lmax[l], ap_j.lmax[l]) < 1e-12
    assert _rel(ap_t.base_inv, ap_j.base_inv) < 1e-12
    assert _rel(fp_t, fp_j) < 1e-12
    assert _rel(mp_t, mp_j) < 1e-12
    from admm_optim_tpu_torch.ops import sparsity

    assert torch.equal(fpt_t, sparsity.transpose_values(ctx.p_space.fine_pattern, fp_t))
    assert tns.ns_pcd_precond_data(ctx.space, ctx.p_space, ctx.pcd_struct, ctx.coords, VISC)[3] is None


@pytest.mark.parametrize("assembled", [True, False], ids=["assembled_bt", "residual_bt"])
def test_ell_pcd_preconditioner_matches_jax(setup, assembled):
    """ns_pcd_M with pcd_schur_ell_M and the ELL velocity cycle, as the JAX
    package's _M_fn composes it: with the assembled B^T (ns_run's M_fn) and
    with the residual's (ns_pcd_M's coords/visc fallback)."""
    ctx, prob, X, s, rng = setup["ctx"], setup["prob"], setup["X"], setup["s"], setup["rng"]
    m_j = prob._ns_pre(X, s=jnp.asarray(s), nu=VISC)
    pre_j, ap_j, fp_j, mp_j = m_j[:4]
    bt_fn = None
    if assembled:
        W_j = prob._ns_jac_builder(X, jnp.asarray(s), VISC)
        bt_fn = lambda zp: prob._ns_bt(zp, W_j)  # noqa: E731
    M_j = jax.jit(jns.ns_pcd_M(prob.ns_space, prob.pre_struct, pre_j, prob.p_space, prob.p_struct, ap_j, fp_j,
                               mp_j, coords=X, visc=VISC, stab=0.0, bt_fn=bt_fn))
    r = rng.normal(size=ctx.n_state)
    m_t = ctx.pre_full(ctx.coords, torch.from_numpy(s), VISC)
    if assembled:
        got = ctx.M_fn(torch.from_numpy(r), *m_t)
    else:
        pre_t, ap_t, fp_t, mp_t, fpt_t = m_t[:5]
        schur = tns.pcd_schur_ell_M(ctx.p_space, ctx.pcd_struct, ap_t, fp_t, mp_t, fpt_t)
        got = tns.ns_pcd_M(ctx.space, schur, tns.ell_velocity_M(ctx.pre_struct, pre_t), coords=ctx.coords,
                           visc=VISC)(torch.from_numpy(r))
    assert _rel(got, M_j(jnp.asarray(r))) < 1e-12


def test_transposed_pcd_preconditioner_is_exact_and_gather_only(setup):
    """transpose_M of ns_run's global PCD M equals the JAX package's
    jax.vjp transpose, <M x, y> = <x, M^T y>, and the graph it replays has
    no index (gather) node, whose backward would scatter in atomic order
    on the card: the Ap levels and Fp carry their transposed values."""
    ctx, prob, X, s, rng = setup["ctx"], setup["prob"], setup["X"], setup["s"], setup["rng"]
    m_t = ctx.pre_full(ctx.coords, torch.from_numpy(s), VISC)
    M = lambda r: ctx.M_fn(r, *m_t)  # noqa: E731
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
    MT = tns.transpose_M(M, ctx.n_state, torch.float64, "cpu")
    m_j = prob._ns_pre(X, s=jnp.asarray(s), nu=VISC)
    W_j = prob._ns_jac_builder(X, jnp.asarray(s), VISC)
    M_j = jns.ns_pcd_M(prob.ns_space, prob.pre_struct, m_j[0], prob.p_space, prob.p_struct, *m_j[1:4],
                       coords=X, visc=VISC, bt_fn=lambda zp: prob._ns_bt(zp, W_j))
    MT_j = jax.jit(jns.transpose_M(M_j, ctx.n_state, jnp.float64))
    a, b = rng.normal(size=ctx.n_state), rng.normal(size=ctx.n_state)
    mtb = MT(torch.from_numpy(b))
    assert _rel(mtb, MT_j(jnp.asarray(b))) < 1e-12
    lhs = float(torch.dot(M(torch.from_numpy(a)), torch.from_numpy(b)))
    assert abs(lhs - float(torch.dot(torch.from_numpy(a), mtb))) <= 1e-12 * abs(lhs)


def test_global_pcd_step_matches_jax():
    """One step with PCD on the global backend from the cold start: the
    JAX package's attempt, counts and drag (torch_obstacle_golden)."""
    kw = dict(V.CONFIGS["pcdg"])
    a = kw.pop("admm")
    jcfg = jobstacle.ProblemConfig(**kw, admm=jadmm.ADMMConfig(**a))
    prob = ObstacleShapeOpt(convert.problem_config(jcfg), device="cpu", dtype=torch.float64)
    assert not prob.use_patch and not prob.use_patch_ns and prob.ns.p_space is not None
    hist = prob.run(num_steps=1)
    obstacle_golden("pcdg", prob, hist, [0])
    assert [log["adjoint"]["iters"] for log in prob.step_log] == golden("pcdg", "adjoint_iters").tolist()
    mesh_invariants(prob, prob.X_final)
