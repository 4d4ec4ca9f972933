"""The port's NS element and operator level (ops.navier_stokes, ops.convdiff,
ops.ns_patchjac) against the JAX package's on the same inputs, float64:
residual, drag, inlet data, lumped pressure mass, the conv-diff element
matrices, the assembled lattice Jacobian blocks, their apply, transposed
apply and B^T coupling.  Cases mirror tests/test_ns_patchjac.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy
from admm_optim_tpu.core.mesh import refine as jrefine
from admm_optim_tpu.core.patches import build_patchset as jbuild_patchset
from admm_optim_tpu.ops import convdiff as jconvdiff
from admm_optim_tpu.ops import navier_stokes as jns
from admm_optim_tpu.ops import ns_patchjac as jjac
from admm_optim_tpu.ops import patchstencil as jst
from admm_optim_tpu.solvers import patch_mg as jpmg
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset
from admm_optim_tpu_torch.ops import convdiff
from admm_optim_tpu_torch.ops import navier_stokes as tns
from admm_optim_tpu_torch.ops import ns_patchjac as tjac
from admm_optim_tpu_torch.ops import patchstencil as tst
from admm_optim_tpu_torch.solvers import patch_mg as tpmg

torch.set_num_threads(1)

NS_DIR = ("inlet", "wall", "obstacle_surface")
VISC = 0.05
CASES = [(2, 1), (3, 0), (3, 1)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _levels(mod_geomgen, mod_refine, dim, refs):
    base = mod_geomgen.channel_2d(diag="fixed") if dim == 2 else mod_geomgen.channel_3d()
    levels = [base]
    for _ in range(refs):
        levels.append(mod_refine(levels[-1]))
    return levels


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}d_refs{c[1]}")
def case(request):
    """Both packages' NS space, level-k and once-refined patchsets, fine
    tables and wiring, plus a random state and direction from one seed."""
    dim, refs = request.param
    jl = _levels(jgeomgen, jrefine, dim, refs)
    tl = _levels(geomgen, refine, dim, refs)
    jh, th = JHierarchy(jl), Hierarchy(tl)
    js, ts = jns.NSSpace.build(jh.fine, vorder=2), tns.NSSpace.build(th.fine, vorder=2)
    jps, tps = jbuild_patchset(jh), build_patchset(th)
    jpre = jbuild_patchset(JHierarchy(jh.levels + [jrefine(jh.fine)]), dirichlet=NS_DIR)
    tpre = build_patchset(Hierarchy(th.levels + [refine(th.fine)]), dirichlet=NS_DIR)
    X = th.fine.coords
    rng = np.random.default_rng(dim * 10 + refs)
    n = ts.n_state
    s = rng.normal(size=n) * 0.3
    x = rng.normal(size=n)
    lam = rng.normal(size=n)
    j = dict(
        space=js, ps=jps, pre=jpre, X=jnp.asarray(X),
        tab_f=jpmg.make_level_tables(jpre, jnp.float64)[-1],
        tab_c=jpmg.make_level_tables(jps, jnp.float64)[-1], wiring=jjac.build_wiring(jps),
    )
    t = dict(
        space=ts, ps=tps, pre=tpre, X=torch.from_numpy(X),
        tab_f=tpmg.make_level_tables(tpre, torch.float64)[-1],
        tab_c=tpmg.make_level_tables(tps, torch.float64)[-1], wiring=tjac.build_wiring(tps),
    )
    return dict(dim=dim, refs=refs, j=j, t=t, s=s, x=x, lam=lam)


def test_wiring_and_memory_match(case):
    j, t = case["j"], case["t"]
    assert tuple(getattr(t["wiring"], f) for f in ("dim", "nbv", "nl", "nclass", "vel_offs", "p_offs")) == \
        tuple(getattr(j["wiring"], f) for f in ("dim", "nbv", "nl", "nclass", "vel_offs", "p_offs"))
    assert tjac.jac_memory_bytes(t["ps"], t["wiring"], 4) == jjac.jac_memory_bytes(j["ps"], j["wiring"], 4)
    for f in ("n_vel", "n_state", "n_pressure"):
        assert getattr(t["space"], f) == getattr(j["space"], f)
    np.testing.assert_array_equal(t["space"].vel_fixed, np.asarray(j["space"].vel_fixed))


def test_residual_drag_inlet_mass_match_jax(case):
    j, t, s = case["j"], case["t"], case["s"]
    sj, st_ = jnp.asarray(s), torch.from_numpy(s)
    assert _rel(tns.ns_residual(t["space"], t["X"], st_, VISC), jns.ns_residual(j["space"], j["X"], sj, VISC, 0.0)) < 1e-12
    assert _rel(tns.ns_residual(t["space"], t["X"], st_, VISC, 0.1),
                jns.ns_residual(j["space"], j["X"], sj, VISC, 0.1)) < 1e-12
    assert _rel(tns.drag(t["space"], t["X"], st_, VISC), jns.drag(j["space"], j["X"], sj, VISC)) < 1e-12
    assert _rel(tns.vel_dof_coords(t["space"], t["X"]), jns.vel_dof_coords(j["space"], j["X"])) < 1e-14
    assert _rel(tns.inlet_values(t["space"], t["X"]), jns.inlet_values(j["space"], j["X"])) < 1e-12
    assert _rel(tns.pressure_mass_lumped(t["space"], t["X"], VISC),
                jns.pressure_mass_lumped(j["space"], j["X"], VISC)) < 1e-12


def test_inlet_gradient_finite_at_the_centerline(case):
    """The double-where safe sqrt: the gradient of the inlet data in the
    coordinates is finite at the r = 0 dofs and equals the JAX package's."""
    j, t = case["j"], case["t"]
    w = np.random.default_rng(5).normal(size=(case["dim"], t["space"].n_vel))
    Xg = t["X"].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(tns.inlet_values(t["space"], Xg) * torch.from_numpy(w)), Xg)
    gj = jax.grad(lambda X: jnp.vdot(jns.inlet_values(j["space"], X), jnp.asarray(w)))(j["X"])
    assert bool(torch.isfinite(g).all())
    assert _rel(g, gj) < 1e-12


@pytest.mark.parametrize("art_diff", [True, False])
def test_convdiff_element_and_corner_mats_match_jax(case, art_diff):
    dim = case["dim"]
    lvl = Hierarchy(_levels(geomgen, refine, dim, 0)).fine
    rng = np.random.default_rng(7)
    w = rng.normal(size=(dim, lvl.num_vertices))
    args = (lvl.coords, lvl.elems.astype(np.int64), w)
    em_t = convdiff.convdiff_elem_mats(*(torch.from_numpy(a) for a in args), 0.16, art_diff=art_diff)
    em_j = jconvdiff.convdiff_elem_mats(*(jnp.asarray(a) for a in args), 0.16, art_diff=art_diff)
    assert _rel(em_t, em_j) < 1e-12
    cw = rng.normal(size=(2 * dim, dim + 1, 4, 6)) * 0.2
    cw[:dim] += np.eye(dim + 1, dim).T[:, :, None, None]  # a unit simplex, perturbed
    for ncomp in (None, 1):
        cm_t = convdiff.convdiff_corner_mats(torch.from_numpy(cw), 0.16, art_diff=art_diff, ncomp=ncomp)
        cm_j = jconvdiff.convdiff_corner_mats(jnp.asarray(cw), 0.16, art_diff=art_diff, ncomp=ncomp)
        assert _rel(cm_t, cm_j) < 1e-12


def test_assembled_jacobian_apply_transpose_and_bt_match_jax(case):
    """The per-class blocks from torch.func.jacfwd + vmap equal jax.jacfwd's;
    J x, J^T x and B^T z_p equal the JAX package's applies of the same
    blocks; J x equals the forward derivative of the residual."""
    j, t, s, x = case["j"], case["t"], case["s"], case["x"]
    W_j = jjac.make_assemble_fn(j["space"], j["ps"], j["pre"], j["wiring"])(j["X"], jnp.asarray(s), VISC)
    W_t = tjac.make_assemble_fn(t["space"], t["ps"], t["pre"], t["wiring"])(t["X"], torch.from_numpy(s), VISC)
    assert tuple(W_t.shape) == tuple(W_j.shape)
    assert _rel(W_t, W_j) < 1e-12
    jv_j, jtv_j = jjac.make_matvec_fns(j["space"], j["ps"], j["pre"], j["wiring"], j["tab_f"], j["tab_c"])
    jv_t, jtv_t = tjac.make_matvec_fns(t["space"], t["ps"], t["pre"], t["wiring"], t["tab_f"], t["tab_c"])
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    y_t = jv_t(xt, W_t)
    assert _rel(y_t, jv_j(xj, W_j)) < 1e-12
    assert _rel(jtv_t(xt, W_t), jtv_j(xj, W_j)) < 1e-12
    R = lambda ss: tns.ns_residual(t["space"], t["X"], ss, VISC)  # noqa: E731
    assert _rel(y_t, torch.func.jvp(R, (torch.from_numpy(s),), (xt,))[1]) < 1e-12
    zp = np.random.default_rng(8).normal(size=t["space"].n_pressure)
    bt_j = jjac.make_bt_fn(j["space"], j["ps"], j["pre"], j["wiring"], j["tab_f"])
    for tab_c in (None, t["tab_c"]):
        bt_t = tjac.make_bt_fn(t["space"], t["ps"], t["pre"], t["wiring"], t["tab_f"], tab_c)
        assert _rel(bt_t(torch.from_numpy(zp), W_t), bt_j(jnp.asarray(zp), W_j)) < 1e-12
    # the lattice layout of the packed state is the JAX package's
    v0, _ = t["space"].unpack(torch.from_numpy(s))
    assert _rel(tst.to_patch(t["pre"].fine, v0), jst.to_patch(j["pre"].fine, j["space"].unpack(jnp.asarray(s))[0])) == 0.0


def test_assembled_jacobian_is_bitwise_equal_across_cell_chunks(case, monkeypatch):
    """JAC_CELL_CHUNK only splits the cells into vmap batches: the blocks
    are bit for bit the same at any chunk (the chunk is timed on the card,
    PERF.md)."""
    t, s = case["t"], torch.from_numpy(case["s"])
    fn = tjac.make_assemble_fn(t["space"], t["ps"], t["pre"], t["wiring"])
    Ws = []
    for chunk in (5, 64, 4096, 65536):
        monkeypatch.setattr(tjac, "JAC_CELL_CHUNK", chunk)
        Ws.append(fn(t["X"], s, VISC))
    assert all(torch.equal(W, Ws[-1]) for W in Ws[:-1])
