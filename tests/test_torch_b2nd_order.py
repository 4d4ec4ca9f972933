"""b2nd_order (-b2ndOrder, 2d_admm.lua:86, 389-419) in the port, float64
on the CPU at 2D refs=1: the J'' term, the directional derivative of the
frozen-(s, lambda) shape gradient (ns_solver.shape_hvp, a double backward
of drag + lambda^T R in X), against central finite differences (rel < 1e-5,
tests/test_b2nd_order.py:30-50) and against the JAX package's jax.jvp; the
x-update's matvec with the term, lane by lane; and one optimization step
(the JAX test's configuration, tests/test_b2nd_order.py:53-66) against the
JAX package's, tests/goldens/e2e_variants.npz ("b2nd")."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_variants_golden as V
from admm_optim_tpu.models import obstacle as jobstacle
from admm_optim_tpu.optim import admm as jadmm
from admm_optim_tpu.solvers import ns_solver as jns
from admm_optim_tpu_torch import convert, ns_run, xupdate_solve
from admm_optim_tpu_torch.models.obstacle import ObstacleShapeOpt, ProblemConfig
from admm_optim_tpu_torch.optim import admm
from admm_optim_tpu_torch.optim.spaces import GlobalOps
from admm_optim_tpu_torch.solvers import ns_solver as tns
from torch_obstacle_golden import VARIANTS_GOLD, golden, mesh_invariants, obstacle_golden

torch.set_num_threads(1)

VISC = V.NS_VISC


def _jax_config():
    kw = dict(V.CONFIGS["b2nd"])
    a = kw.pop("admm")
    return jobstacle.ProblemConfig(**kw, admm=jadmm.ADMMConfig(**a))


@pytest.fixture(scope="module")
def flow():
    """The converged visc 0.16 state of the JAX package's matrix-free run
    (the same P2 state) and the port's adjoint there."""
    ctx = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=2)
    s = torch.from_numpy(VARIANTS_GOLD["ns_mf_s"])
    lam = ns_run.adjoint(ctx, s).lam
    return ctx, s, lam


def test_jpp_directional_derivative_matches_fd_and_jax(flow):
    ctx, s, lam = flow
    X = ctx.coords

    def g(XX):  # the frozen shape gradient as _admm freezes it
        return tns.shape_gradient(ctx.space, XX, s, lam, VISC, 0.0, ctx.obstacle_vmask).T * ctx.free_def

    v = torch.from_numpy(np.random.default_rng(0).normal(size=tuple(X.shape)))
    hvp = tns.shape_hvp(ctx.space, X, s, lam, VISC, 0.0, ctx.obstacle_vmask)(v).T * ctx.free_def
    eps = 1e-6
    fd = (g(X + eps * v) - g(X - eps * v)) / (2 * eps)
    err = float(torch.linalg.vector_norm(hvp - fd) / torch.clamp_min(torch.linalg.vector_norm(fd), 1e-30))
    assert err < 1e-5, f"J'' hvp vs FD: rel err {err}"
    jprob = jobstacle.ObstacleShapeOpt(_jax_config())

    def gj(XX):
        return jns.shape_gradient(jprob.ns_space, XX, jnp.asarray(s.numpy()), jnp.asarray(lam.numpy()), VISC,
                                  0.0, jprob.obstacle_vmask).T * jprob.free

    want = np.asarray(jax.jvp(gj, (jprob.X0,), (jnp.asarray(v.numpy()),))[1])
    assert np.abs(hvp.numpy() - want).max() <= 1e-10 * np.abs(want).max()


def test_xupdate_matvec_with_the_extra_term_takes_lanes():
    """_hess_apply: A x + Lambda^T g'' x + J'' x, the J'' term on one field;
    a (1+m, C, V) stack gives each lane's own apply."""
    prob = ObstacleShapeOpt(ProblemConfig(dim=2, num_refs=1, visc=VISC, backend="global"), device="cpu",
                            dtype=torch.float64)
    X = prob.X0
    ops_ = GlobalOps(prob.xu.struct, xupdate_solve.assemble(prob.xu, X), X, prob.elems, prob.ns.free_def,
                     prob.xu.vplan)
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.normal(size=tuple(ops_.free.shape)) * 1e-3) * ops_.free
    Lam = torch.from_numpy(rng.normal(size=3))
    K = torch.from_numpy(rng.normal(size=(X.shape[0], X.shape[0]))) * 1e-2

    def extra(x):
        assert x.shape == ops_.free.shape
        return x @ K

    apply = admm._hess_apply(ops_, u, Lam, prob.ref_volume, prob.ref_barycenter, extra)
    xs = torch.from_numpy(rng.normal(size=(4,) + tuple(ops_.free.shape)))
    hvp = ops_.hvp_fn(u, Lam, prob.ref_volume, prob.ref_barycenter)
    got = apply(xs)
    for i in range(4):
        want = ops_.A(xs[i]) + hvp(xs[i]) + extra(xs[i] * ops_.free) * ops_.free
        assert torch.equal(got[i], want)
        assert torch.equal(apply(xs[i]), want)


def test_b2nd_order_step_matches_jax():
    """One accepted step with the J'' term (hscaling 1): the x-update on the
    global backend, the NS side on the patch backend; the JAX package's
    attempt, counts and drag."""
    prob = ObstacleShapeOpt(convert.problem_config(_jax_config()), device="cpu", dtype=torch.float64)
    assert not prob.use_patch and prob.use_patch_ns and prob.xu.ps is None
    hist = prob.run(num_steps=1)
    obstacle_golden("b2nd", prob, hist, [0])
    assert [log["adjoint"]["iters"] for log in prob.step_log] == golden("b2nd", "adjoint_iters").tolist()
    assert hist[0].drag_diff > 0.0
    mesh_invariants(prob, prob.X_final)


def test_b2nd_order_on_the_patch_backend_is_refused():
    with pytest.raises(ValueError, match="b2nd_order"):
        ObstacleShapeOpt(ProblemConfig(num_refs=0, backend="patch", b2nd_order=True), device="cpu")
