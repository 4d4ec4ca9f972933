"""The port's NS preconditioner and solver set-up (solvers/ns_solver.py,
ns_run.py, convert.py) against the JAX package's, float64 on the CPU: the
conv-diff V-cycle data on the once-refined lattice, the block-triangular
preconditioner M, its exact transpose (autograd, K5^T's twin through
the V-cycle), the Newton configuration and its f32 presets, the restart
lengths and the continuation ladder.  The JAX side is wired as
models/obstacle.py wires it for the patch backend."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_optim_tpu.models import obstacle
from admm_optim_tpu.solvers import ns_solver as jns
from admm_optim_tpu_torch import convert, ns_run
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.solvers import ns_solver as tns

torch.set_num_threads(1)

VISC = 0.16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module", params=[(2, 1), (3, 0)], ids=["2d_refs1", "3d_refs0"])
def setup(request):
    """Both packages' preconditioner at one perturbed cold-start state:
    the JAX M composed as obstacle.py's _M_fn composes it, the port's from
    ns_run."""
    dim, refs = request.param
    prob = obstacle.ObstacleShapeOpt(obstacle.ProblemConfig(dim=dim, num_refs=refs, visc=VISC))
    assert prob.use_patch_ns and prob.use_ns_jac
    ctx = ns_run.build(refs, "cpu", torch.float64, visc=VISC, dim=dim)
    X = prob.X0
    rng = np.random.default_rng(dim)
    s = np.asarray(prob.initial_state(X)) + 0.1 * rng.normal(size=ctx.n_state)
    np.testing.assert_array_equal(ns_run.initial_state(ctx).numpy(), np.asarray(prob.initial_state(X)))
    pre_j, pdiag_j, _ = prob._ns_pre(X, s=jnp.asarray(s), nu=VISC)
    W_j = prob._ns_jac_builder(X, jnp.asarray(s), VISC)
    M_j = jax.jit(jns.ns_gmg_M(
        prob.ns_space, prob.pre_struct, pre_j, pdiag_j,
        vel_M=jns.patch_velocity_M(prob.pre_ps, prob._pre_struct_p, pre_j),
        coords=X, visc=VISC, stab=0.0, bt_fn=lambda zp: prob._ns_bt(zp, W_j),
    ))
    m_t = ctx.pre_full(ctx.coords, convert.ns_state(s, "cpu"), VISC)
    return dict(prob=prob, ctx=ctx, s=s, pre_j=pre_j, pdiag_j=pdiag_j, W_j=W_j, M_j=M_j, m_t=m_t)


def test_velocity_vcycle_data_matches_jax(setup):
    """The conv-diff hierarchy on [coords | velocity] (full slot-major W,
    nonsymmetric), Jacobi data, the dense base inverse, the pressure block
    and the assembled Jacobian."""
    pre_t, pdiag_t, _, W_t = setup["m_t"]
    pre_j = setup["pre_j"]
    assert len(pre_t.W) == len(pre_j.W)
    for l in range(len(pre_t.W)):
        assert pre_t.W[l].shape[0] == (15 if setup["ctx"].pre_ps.dim == 3 else 7)
        assert _rel(pre_t.W[l], pre_j.W[l]) < 1e-12
        assert _rel(pre_t.inv_diag[l], pre_j.inv_diag[l]) < 1e-12
        assert _rel(pre_t.lmax[l], pre_j.lmax[l]) < 1e-12
    assert pre_t.W_sm is None  # smoother_w="f32": the V-cycle streams W itself
    assert _rel(pre_t.base_inv, pre_j.base_inv) < 1e-12
    assert _rel(pdiag_t, setup["pdiag_j"]) < 1e-12
    assert _rel(W_t, setup["W_j"]) < 1e-12


def test_preconditioner_matches_jax(setup):
    """ns_gmg_M with patch_velocity_M and the assembled B^T, on the same r;
    two velocity V-cycles (iters=2) as well."""
    ctx, m_t = setup["ctx"], setup["m_t"]
    r = np.random.default_rng(11).normal(size=ctx.n_state)
    assert _rel(ctx.M_fn(torch.from_numpy(r), *m_t), setup["M_j"](jnp.asarray(r))) < 1e-12
    rv = r[: ctx.space.n_vel * ctx.space.dim].reshape(ctx.space.dim, -1)
    z_t = tns.patch_velocity_M(ctx.pre_ps, ctx.pre_struct, m_t[0], iters=2)(torch.from_numpy(rv))
    prob = setup["prob"]
    z_j = jax.jit(jns.patch_velocity_M(prob.pre_ps, prob._pre_struct_p, setup["pre_j"], iters=2))(jnp.asarray(rv))
    assert _rel(z_t, z_j) < 1e-12


def test_transpose_M_matches_jax_and_is_exact(setup):
    """transpose_M (the recorded vjp through the V-cycle, whose full-W applies
    take K5^T's twin as their backward) equals the JAX package's jax.vjp
    transpose, and <M x, y> = <x, M^T y>."""
    ctx, m_t = setup["ctx"], setup["m_t"]
    rng = np.random.default_rng(12)
    x, y = rng.normal(size=ctx.n_state), rng.normal(size=ctx.n_state)
    M_t = lambda r: ctx.M_fn(r, *m_t)  # noqa: E731
    MT_t = tns.transpose_M(M_t, ctx.n_state, torch.float64, "cpu")
    MT_j = jax.jit(jns.transpose_M(setup["M_j"], ctx.n_state, jnp.float64))
    sk.reset_launches()
    mty = MT_t(torch.from_numpy(y))
    assert sum(sk.launches.values()) == 0  # CPU tensors take the twins
    assert _rel(mty, MT_j(jnp.asarray(y))) < 1e-12
    a = float(torch.dot(M_t(torch.from_numpy(x)), torch.from_numpy(y)))
    b = float(torch.dot(torch.from_numpy(x), mty))
    assert abs(a - b) <= 1e-12 * max(abs(a), abs(b))


def test_transpose_M_of_a_nonsymmetric_map():
    """tests/test_ns.py's exactness check on a nonsymmetric linear map."""
    n = 257
    rng = np.random.default_rng(3)
    d1 = torch.from_numpy(rng.normal(size=n)) + 2.0
    d2 = torch.from_numpy(rng.normal(size=n))
    M = lambda r: r * d1 + torch.roll(r, 1) * d2  # noqa: E731
    MT = tns.transpose_M(M, n, torch.float64, "cpu")
    x, y = (torch.from_numpy(rng.normal(size=n)) for _ in range(2))
    a, b = float(torch.dot(M(x), y)), float(torch.dot(x, MT(y)))
    assert abs(a - b) <= 1e-12 * max(abs(a), abs(b))
    MTj = jns.transpose_M(lambda r: r * jnp.asarray(d1.numpy()) + jnp.roll(r, 1) * jnp.asarray(d2.numpy()),
                          n, jnp.float64)
    assert _rel(MT(y), MTj(jnp.asarray(y.numpy()))) < 1e-14


def test_newton_config_presets_and_restart_lengths_match_jax():
    """NewtonConfig defaults, f32_presets, _restart_len, _chunked_rl and the
    continuation ladder are the JAX package's; convert.newton_config and
    convert.ns_state carry its objects over."""
    jcfg = jns.NewtonConfig()
    assert dataclasses.asdict(convert.newton_config(jcfg)) == dataclasses.asdict(tns.NewtonConfig())
    assert {f.name for f in dataclasses.fields(tns.NewtonConfig)} == {f.name for f in dataclasses.fields(jcfg)}
    jf32 = obstacle.f32_presets(obstacle.ProblemConfig()).ns
    assert convert.newton_config(jf32) == ns_run.f32_presets(tns.NewtonConfig())
    for n in (2504, 51168, 383400, 5_000_000):
        for isz in (4, 8):
            assert tns._restart_len(jcfg, n, isz) == jns._restart_len(jcfg, n, isz)
            assert tns._restart_len(jcfg, n, isz, mult=2) == jns._restart_len(jcfg, n, isz, mult=2)
            assert tns._chunked_rl(jcfg, n, isz) == jns._chunked_rl(jcfg, n, isz)
    for visc in (0.16, 0.05, 0.02, 0.2):
        assert ns_run.continuation_ladder(visc) == obstacle._continuation_ladder(visc)
    s = np.random.default_rng(0).normal(size=33)
    t = convert.ns_state(jnp.asarray(s), "cpu")
    assert t.dtype == torch.float64 and np.array_equal(t.numpy(), s)
    assert convert.ns_state(s, "cpu", torch.float32).dtype == torch.float32


def test_jax_grad_of_drag_matches_port(setup):
    """The adjoint's right-hand side: dJ_drag/ds by autograd."""
    ctx, prob, s = setup["ctx"], setup["prob"], setup["s"]
    from admm_optim_tpu.ops import navier_stokes as jnsops

    g_t = tns.drag_gradient(ctx.space, ctx.coords, torch.from_numpy(s), VISC)
    g_j = jax.grad(lambda ss: jnsops.drag(prob.ns_space, prob.X0, ss, VISC))(jnp.asarray(s))
    assert _rel(g_t, g_j) < 1e-12
