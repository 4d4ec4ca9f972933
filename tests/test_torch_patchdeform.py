"""The port's patch deformation ops (ops/patchdeform.py) and the PatchOps
adapter (optim/spaces.py) against the JAX package on the ADMM fixtures
of tests/test_patch_admm.py (2D refs=2, 3D refs=1), float64, with the
patch-validity mask off and on: constraints and their analytic
derivatives, the right-hand sides, the z-prox (Frobenius and spectral),
the dual update, the norms, the assembled constraint Hessian, and the
adapter's exchanged fields and Gram blocks."""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from admm_optim_tpu.ops import patchdeform as jpd
from admm_optim_tpu.ops import patchstencil as jst
from admm_optim_tpu.optim.spaces import PatchOps as JPatchOps
from admm_optim_tpu.solvers import patch_mg as jmg
from admm_optim_tpu_torch.ops import patchdeform as tpd
from admm_optim_tpu_torch.ops import patchstencil as st
from torch_admm_problems import jbuild_patchset, JHierarchy, _levels, jgeomgen, jrefine, port_problem

torch.set_num_threads(1)

CASES = [(2, 2), (3, 1)]


@pytest.fixture(scope="module", params=CASES, ids=["2d_refs2", "3d_refs1"])
def case(request):
    """The JAX patchset and tables, the port's fixture problem, and random
    inputs from one numpy seed: u, x (C, *lat, P), Lambda (m,), a per-cell
    tensor field (d, d, T, *cells, P), and the patch-validity mask."""
    dim, refs = request.param
    jps = jbuild_patchset(JHierarchy(_levels(jgeomgen, jrefine, dim, refs)))
    p = port_problem(dim, refs)
    rng = np.random.default_rng(7 + dim)
    cp = p.ops.coords_p.numpy()
    free = p.ops.free.numpy()
    T = len(p.ps.class_offsets)
    tshape = (dim, dim, T) + (p.ps.fine.m,) * dim + (p.ps.P,)
    return types.SimpleNamespace(
        dim=dim, jps=jps, p=p, ps=p.ps, cp=cp,
        u=rng.normal(size=cp.shape) * 0.05 * free, x=rng.normal(size=cp.shape) * free,
        Lm=rng.normal(size=(1 + dim,)), M=rng.normal(size=tshape) * 0.1,
        pvalid=(np.arange(p.ps.P) % 5 != 0).astype(np.float64),
        jtabs=jmg.make_level_tables(jps, jnp.float64),
    )


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _pv(c, masked):
    return (c.pvalid, _t(c.pvalid)) if masked else (None, None)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pvalid"])
def test_constraint_functionals_match_jax(case, masked):
    c = case
    jpv, tpv = _pv(c, masked)
    jpv = None if jpv is None else jnp.asarray(jpv)
    zd = np.zeros(c.dim)
    ja = (c.jps, jnp.asarray(c.cp), jnp.asarray(c.u))
    geo = tpd.cell_geometry(c.ps, _t(c.cp), tpv)
    ta = (c.ps, geo, _t(c.u))
    g_j = jpd.constraints_p(*ja, 0.3, jnp.asarray(zd + 0.1), pvalid=jpv)
    g_t = tpd.constraints_p(*ta, 0.3, _t(zd + 0.1))
    assert _rel(g_t, g_j) <= 1e-12
    B_j = jpd.constraint_grads_analytic_p(*ja, 0.0, jnp.asarray(zd), pvalid=jpv)
    B_t = tpd.constraint_grads_analytic_p(*ta, 0.0, _t(zd))
    assert B_t.shape == (1 + c.dim,) + c.u.shape and _rel(B_t, B_j) <= 1e-12
    h_j = jpd.constraint_hvp_analytic_p(*ja, jnp.asarray(c.Lm), 0.0, jnp.asarray(zd), jnp.asarray(c.x), pvalid=jpv)
    h_t = tpd.constraint_hvp_analytic_p(*ta, _t(c.Lm), 0.0, _t(zd), _t(c.x))
    assert _rel(h_t, h_j) <= 1e-12
    r_j = jpd.tensor_rhs_p(c.jps, jnp.asarray(c.cp), jnp.asarray(c.M))
    r_t = tpd.tensor_rhs_p(c.ps, geo, _t(c.M))
    assert _rel(r_t, r_j) <= 1e-12


def test_prox_dual_update_and_norms_match_jax(case):
    c = case
    ja = (c.jps, jnp.asarray(c.cp), jnp.asarray(c.u))
    ta = (c.ps, tpd.cell_geometry(c.ps, _t(c.cp)), _t(c.u))
    lam_j, lam_t = jnp.asarray(c.M), _t(c.M)
    for norm in ("frobenius", "spectral"):
        # sigma small enough that many cells hit the projection boundary
        q_j = jpd.z_update_p(*ja, lam_j, 2.0, 0.08, norm)
        q_t = tpd.z_update_p(*ta, lam_t, 2.0, 0.08, norm)
        assert _rel(q_t, q_j) <= 1e-12, norm
        nl_j, inc_j = jpd.dual_update_p(*ja, lam_j, q_j, 2.0)
        nl_t, inc_t = tpd.dual_update_p(*ta, lam_t, q_t, 2.0)
        assert _rel(nl_t, nl_j) <= 1e-12 and _rel(inc_t, inc_j) <= 1e-12
    for masked in (False, True):
        jpv, tpv = _pv(c, masked)
        jpv = None if jpv is None else jnp.asarray(jpv)
        geo = tpd.cell_geometry(c.ps, _t(c.cp), tpv)
        for jf, tf in (
            (jpd.max_frobenius_norm_p, tpd.max_frobenius_norm_p),
            (jpd.max_spectral_norm_p, tpd.max_spectral_norm_p),
        ):
            assert _rel(tf(c.ps, geo, _t(c.u), tpv), jf(*ja, jpv)) <= 1e-12
        assert _rel(tpd.l2_norm_p1_p(c.ps, geo, _t(c.u)), jpd.l2_norm_p1_p(*ja, jpv)) <= 1e-12
        assert _rel(
            tpd.l2_norm_pc_p(c.ps, geo, lam_t),
            jpd.l2_norm_pc_p(c.jps, jnp.asarray(c.cp), lam_j, jpv),
        ) <= 1e-12


@pytest.mark.parametrize("sym", [False, True], ids=["full", "sym"])
def test_assembled_constraint_hessian_matches_jax(case, sym):
    """W_h of hvp_corner_block_fn through assemble_w (the block protocol),
    Dirichlet-baked, in full and symmetric-half storage."""
    c = case
    free = c.ps.fine.free
    stacked = np.concatenate([c.cp, c.u], axis=0)
    W_j = jst.assemble_w(
        c.jps, c.jps.k, jnp.asarray(stacked), jpd.hvp_corner_block_fn(jnp.asarray(c.Lm)),
        sym=sym, free=jnp.asarray(free, jnp.float64),
    )
    W_t = st.assemble_w(
        c.ps, c.ps.k, _t(stacked), tpd.hvp_corner_block_fn(_t(c.Lm)), sym=sym, free=_t(free),
    )
    assert W_t.shape == W_j.shape and _rel(W_t, W_j) <= 1e-12


def test_patchops_fields_and_gram_blocks_match_jax(case):
    """The adapter's exchanged (consistent, free-masked) fields: a missing
    exchange would leave the Schur matrix off by the duplication factor."""
    c = case
    jops = JPatchOps(jmg.PatchMGStructure(c.jps), types.SimpleNamespace(tabs=c.jtabs), jnp.asarray(c.cp))
    tops = c.p.ops
    refv, refb = 1.5, np.full(c.dim, 0.2)
    u_j, u_t = jnp.asarray(c.u), _t(c.u)
    assert _rel(tops.constraints(u_t, refv, _t(refb)), jops.constraints(u_j, refv, jnp.asarray(refb))) <= 1e-12
    B_j = jops.constraint_grads(u_j, refv, jnp.asarray(refb))
    B_t = tops.constraint_grads(u_t, refv, _t(refb))
    assert _rel(B_t, B_j) <= 1e-12
    assert _rel(tops.tensor_rhs(_t(c.M)), jops.tensor_rhs(jnp.asarray(c.M))) <= 1e-12
    sols = np.concatenate([c.x[None], np.asarray(B_j)])
    G_j = jops.dot_batch(B_j, jnp.asarray(sols))
    G_t = tops.dot_batch(B_t, _t(sols))
    assert G_t.shape == (1 + c.dim, 2 + c.dim) and _rel(G_t, G_j) <= 1e-12
    # the per-lane owner dot is the Gram diagonal
    d_t = tops.dot(B_t, B_t)
    assert d_t.shape == (1 + c.dim,) and _rel(d_t, np.diag(np.asarray(G_j)[:, 1:])) <= 1e-12
    h_j = jops.constraint_hvp(u_j, jnp.asarray(c.Lm), refv, jnp.asarray(refb), jnp.asarray(c.x))
    h_t = tops.constraint_hvp(u_t, _t(c.Lm), refv, _t(refb), _t(c.x))
    assert _rel(h_t, h_j) <= 1e-12


def test_hess_fn_matches_matvec_hvp(case):
    """PatchOps.hess_fn (constraint Hessian assembled into the stencil) ==
    A + the matvec-side HVP, for one field and for a lane axis
    (tests/test_patch_admm.py:273-294)."""
    c = case
    ops = c.p.ops
    u, Lm = _t(c.u) * 0.6, _t(c.Lm)
    x = _t(c.x)
    h_ref = ops.A(x) + ops.hvp_fn(u, Lm, 0.0, None)(x)
    hess = ops.hess_fn(u, Lm, 0.0, None)
    h_asm = hess(x)
    assert float((h_asm - h_ref).norm()) <= 1e-11 * float(h_ref.norm())
    xb = torch.stack([x, 2.0 * x, -x])
    hb = hess(xb)
    assert hb.shape == xb.shape
    assert float((hb - torch.stack([h_asm, 2.0 * h_asm, -h_asm])).abs().max()) <= 1e-12 * float(h_asm.abs().max())
