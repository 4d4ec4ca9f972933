"""The port's global-representation x-update operators (ops/deformation.py's
constraint functionals, their closed-form gradients and Hessian, the RHS,
the z-prox and dual update; optim/spaces.py GlobalOps with its assembled
Hessian and V-cycle) against the JAX package's GlobalOps, float64, on the
2D channel with alternating diagonals refined twice and the 3D channel
refined once, from one numpy seed: operators to 1e-12 of their largest
entry (the Hessian against the JAX package's forward-over-reverse AD).
Then GlobalOps against PatchOps on one brick mesh, as tests/test_patch_admm.py
holds the JAX package's: the same operators through both adapters, and the
same ADMM trajectory."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy, refine as jrefine
from admm_optim_tpu.ops import deformation as jdfm
from admm_optim_tpu.ops.geometry import elem_geometry as jgeom
from admm_optim_tpu.ops.p1space import P1VectorSpace as JSpace
from admm_optim_tpu.optim.spaces import GlobalOps as JGlobalOps
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.ops import deformation as dfm
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops.p1space import P1VectorSpace
from admm_optim_tpu_torch.optim import admm
from admm_optim_tpu_torch.optim.spaces import GlobalOps
from torch_admm_problems import FIXTURE_CFG, SCALING, SIGMA, port_problem

torch.set_num_threads(1)

TAU = 2.0


def _hier(gm, rf, H, dim, refs, diag="alt"):
    levels = [gm.channel_2d(diag=diag) if dim == 2 else gm.channel_3d()]
    for _ in range(refs):
        levels.append(rf(levels[-1]))
    return H(levels)


def port_global_ops(hier, vplan=True):
    space = P1VectorSpace.build(hier)
    struct = space.mg_structure()
    X = torch.as_tensor(hier.fine.coords)
    elems = torch.as_tensor(hier.fine.elems.astype(np.int64))
    plan = dfm.vertex_plan(hier.fine.elems, hier.fine.num_vertices) if vplan else None
    return GlobalOps(struct, space.assemble_mg(struct, X, 1.0, TAU, 1.0), X, elems, space.free_mask(), plan)


@pytest.fixture(scope="module", params=[(2, 2), (3, 1)], ids=["2d_refs2", "3d_refs1"])
def case(request):
    dim, refs = request.param
    jh = _hier(jgeomgen, jrefine, JHierarchy, dim, refs)
    th = _hier(geomgen, refine, Hierarchy, dim, refs)
    jsp_ = JSpace.build(jh)
    jst = jsp_.mg_structure()
    X = jnp.asarray(jh.fine.coords)
    jops = JGlobalOps(jst, jsp_.assemble_mg(jst, X, 1.0, TAU, 1.0), X, jnp.asarray(jh.fine.elems), jsp_.free_mask())
    tops = port_global_ops(th)
    _, _, _, vol = jgeom(X, jops.elems)
    refs_ = (jnp.sum(vol), jdfm.barycenter(X, jops.elems, jnp.zeros_like(X.T)))
    rng = np.random.default_rng(11 + dim)
    V, E = th.fine.num_vertices, th.fine.num_elems
    free = tops.free.numpy()
    inp = dict(u=rng.normal(size=(dim, V)) * free * 1e-2, x=rng.normal(size=(3, dim, V)) * free,
               L=rng.normal(size=1 + dim), M=rng.normal(size=(dim, dim, E)), lam=rng.normal(size=(dim, dim, E)))
    return dict(dim=dim, jops=jops, tops=tops, refs=refs_, inp=inp)


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def test_constraints_gradients_and_hessian(case):
    j, t, inp = case["jops"], case["tops"], case["inp"]
    rv, rb = case["refs"]
    trv, trb = torch.tensor(np.asarray(rv)), torch.tensor(np.asarray(rb))
    ju, tu = jnp.asarray(inp["u"]), torch.as_tensor(inp["u"])
    jL, tL = jnp.asarray(inp["L"]), torch.as_tensor(inp["L"])
    _close(t.constraints(tu, trv, trb), j.constraints(ju, rv, rb), 1e-10)  # defects of ~1e-3 of sums ~1e2
    _close(t.constraint_grads(tu, trv, trb), j.constraint_grads(ju, rv, rb))
    x0 = inp["x"][0]
    _close(t.constraint_hvp(tu, tL, trv, trb, torch.as_tensor(x0)), j.constraint_hvp(ju, jL, rv, rb, jnp.asarray(x0)))
    _close(t.hvp_fn(tu, tL, trv, trb)(torch.as_tensor(x0)), j.hvp_fn(ju, jL, rv, rb)(jnp.asarray(x0)))
    _close(dfm.hvp_elem_mats(t.coords, t.elems, tu, tL), jdfm.hvp_elem_mats(j.coords, j.elems, ju, jL))
    # the assembled Hessian, on three lanes at once
    H = t.hess_fn(tu, tL, trv, trb)(torch.as_tensor(inp["x"]))
    jH = j.hess_fn(ju, jL, rv, rb)
    for k in range(3):
        _close(H[k], jH(jnp.asarray(inp["x"][k])))
    # and against A + the JAX package's AD Hessian-vector product
    _close(H[0] * t.free, (j.A(jnp.asarray(x0)) + j.constraint_hvp(ju, jL, rv, rb, jnp.asarray(x0))) * j.free)


def test_rhs_prox_dual_and_norms(case):
    j, t, inp = case["jops"], case["tops"], case["inp"]
    ju, tu = jnp.asarray(inp["u"]), torch.as_tensor(inp["u"])
    jM, tM = jnp.asarray(inp["M"]), torch.as_tensor(inp["M"])
    jl, tl = jnp.asarray(inp["lam"]), torch.as_tensor(inp["lam"])
    _close(t.tensor_rhs(tM), j.tensor_rhs(jM))
    _close(dfm.tensor_rhs(t.coords, t.elems, tM), jdfm.tensor_rhs(j.coords, j.elems, jM))
    _close(t.grad_tensor(tu), j.grad_tensor(ju))
    for norm in ("frobenius", "spectral"):
        _close(t.z_update(tu, tl, TAU, 0.01, norm), j.z_update(ju, jl, TAU, 0.01, norm))
        _close(t.max_grad_norm(tu, norm), j.max_grad_norm(ju, norm))
    q = t.z_update(tu, tl, TAU, 0.01, "frobenius")
    for got, want in zip(t.dual_update(tu, tl, q, TAU), j.dual_update(ju, jl, jnp.asarray(q.numpy()), TAU)):
        _close(got, want)
    _close(t.norm_p1(tu), j.norm_p1(ju))
    _close(t.norm_pc(tl), j.norm_pc(jl))


def test_operator_preconditioner_and_dots_on_lanes(case):
    j, t, inp = case["jops"], case["tops"], case["inp"]
    X = torch.as_tensor(inp["x"])
    A, Mx, d = t.A(X), t.M(X), t.dot(X, X)
    for k in range(3):
        xk = jnp.asarray(inp["x"][k])
        _close(A[k], j.A(xk))
        _close(Mx[k], j.M(xk))
        _close(d[k], j.dot(xk, xk))
    _close(t.dot_batch(X, A), j.dot_batch(jnp.asarray(inp["x"]), jnp.asarray(A.numpy())))


@pytest.mark.parametrize("dim,refs", [(2, 2), (3, 1)])
def test_global_ops_match_patch_ops(dim, refs):
    """On the brick mesh of the ADMM fixture (tests/test_patch_admm.py:31),
    both adapters of the port give the same operators, and admm_inner the
    same trajectory over them (the JAX package's tolerances), cut at two
    ADMM iterations as tests/test_torch_admm.py cuts the fixture's run."""
    p = port_problem(dim, refs)
    fine = p.hier.fine
    g = port_global_ops(p.hier)
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.normal(size=(dim, fine.num_vertices))) * g.free * 1e-2
    up = st.to_patch(p.ps.fine, u)
    x = torch.as_tensor(rng.normal(size=(dim, fine.num_vertices))) * g.free
    xp = st.to_patch(p.ps.fine, x)
    L = torch.as_tensor(rng.normal(size=1 + dim))
    np.testing.assert_allclose(g.constraints(u, p.ref_vol, p.ref_bary).numpy(),
                               p.ops.constraints(up, p.ref_vol, p.ref_bary).numpy(), rtol=1e-10, atol=1e-12)
    Bg, Bp = g.constraint_grads(u, p.ref_vol, p.ref_bary), p.ops.constraint_grads(up, p.ref_vol, p.ref_bary)
    np.testing.assert_allclose(g.dot(Bg, x).numpy(), p.ops.dot(Bp, xp[None]).numpy(), rtol=1e-9, atol=1e-12)
    hg = g.hess_fn(u, L, p.ref_vol, p.ref_bary)(x)
    hp = st.from_patch(p.ps.fine, p.ops.hess_fn(up, L, p.ref_vol, p.ref_bary)(xp), fine.num_vertices, mode="owner")
    np.testing.assert_allclose(hp.numpy(), hg.numpy(), rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(float(g.norm_p1(u)), float(p.ops.norm_p1(up)), rtol=1e-10)
    cfg = admm.ADMMConfig(**dict(FIXTURE_CFG, admm_steps=2))
    Jp = st.from_patch(p.ps.fine, p.Jp, fine.num_vertices, mode="owner")
    sg = admm.admm_inner(cfg, g, Jp, SIGMA, SCALING, p.ref_vol, p.ref_bary)
    sp_ = admm.admm_inner(cfg, p.ops, p.Jp, SIGMA, SCALING, p.ref_vol, p.ref_bary)
    assert (sg.converged, sg.failed, sg.admm_it, sg.total_newton) == (
        sp_.converged, sp_.failed, sp_.admm_it, sp_.total_newton)
    np.testing.assert_allclose(sg.Lambda.numpy(), sp_.Lambda.numpy(), rtol=1e-6, atol=1e-9)
    u_pg = st.from_patch(p.ps.fine, sp_.u, fine.num_vertices, mode="owner")
    assert float(torch.linalg.vector_norm(u_pg - sg.u) / torch.linalg.vector_norm(sg.u)) < 1e-6
