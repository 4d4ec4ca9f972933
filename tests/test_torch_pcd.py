"""The port's PCD (pressure convection-diffusion, Kay-Loghin-Wathen) Schur
block on the patch backend (solvers/ns_solver.py pcd_patch_tables,
ns_pcd_precond_data_patch, pcd_schur_patch_M, ns_pcd_M; ns_run's wiring;
convert.pcd_data) against the JAX package's, float64 on the CPU, on the
refs=1 2D and refs=0 3D geomgen channels.  The JAX side is wired as
models/obstacle.py wires it for ``pressure_precond="pcd"``.  On the GPU the
scalar stencils go through the full-stencil kernel at C = 1; here every
apply is its plain twin, which the tests also check counts no launch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_optim_tpu.models import obstacle
from admm_optim_tpu.ops import sparsity as jsparsity
from admm_optim_tpu.ops.convdiff import convdiff_corner_mats as jcorner
from admm_optim_tpu.ops.convdiff import convdiff_elem_mats as jelem
from admm_optim_tpu.solvers import ns_solver as jns
from admm_optim_tpu_torch import convert, ns_run
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import sparsity
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.ops.convdiff import convdiff_corner_mats, convdiff_elem_mats
from admm_optim_tpu_torch.solvers import ns_solver as tns

torch.set_num_threads(1)

VISC = 0.04  # a lower rung of the ladder: convection matters in Fp


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module", params=[(2, 1), (3, 0)], ids=["2d_refs1", "3d_refs0"])
def setup(request):
    """Both packages' PCD preconditioner at one perturbed cold-start state:
    the JAX data from obstacle.py's _ns_pre and its M composed as _M_fn
    composes it, the port's from ns_run."""
    dim, refs = request.param
    prob = obstacle.ObstacleShapeOpt(
        obstacle.ProblemConfig(dim=dim, num_refs=refs, visc=VISC, pressure_precond="pcd"))
    assert prob.use_patch_ns and prob.use_ns_jac
    ctx = ns_run.build(refs, "cpu", torch.float64, visc=VISC, dim=dim, pressure_precond="pcd")
    X = prob.X0
    s = np.asarray(prob.initial_state(X)) + 0.1 * np.random.default_rng(dim).normal(size=ctx.n_state)
    pre_j, ap_j, Wfp_j, mp_j, _ = prob._ns_pre(X, s=jnp.asarray(s), nu=VISC)
    W_j = prob._ns_jac_builder(X, jnp.asarray(s), VISC)
    schur_j = jns.pcd_schur_patch_M(
        prob.ns_space, prob._ps_k, prob._pcd_struct_p, prob._pcd_tabs, ap_j, Wfp_j, mp_j)
    M_j = jax.jit(jns.ns_pcd_M(
        prob.ns_space, prob.pre_struct, pre_j, None, None, None, None, mp_j,
        coords=X, visc=VISC, stab=0.0,
        vel_M=jns.patch_velocity_M(prob.pre_ps, prob._pre_struct_p, pre_j),
        bt_fn=lambda zp: prob._ns_bt(zp, W_j), schur_fn=schur_j,
    ))
    m_t = ctx.pre_full(ctx.coords, convert.ns_state(s, "cpu"), VISC)
    return dict(prob=prob, ctx=ctx, s=s, ap_j=ap_j, Wfp_j=Wfp_j, mp_j=mp_j, schur_j=jax.jit(schur_j),
                M_j=M_j, m_t=m_t)


def test_scalar_convdiff_element_matrices_match_jax():
    """convdiff_corner_mats / convdiff_elem_mats with ncomp=1: the plain
    Galerkin Fp form (art_diff=False) and the unit-viscosity w=0 Laplacian
    of Ap, to 1e-13."""
    rng = np.random.default_rng(0)
    for d in (2, 3):
        cw = rng.normal(size=(2 * d, d + 1, 4, 5))
        cw0 = cw.copy()
        cw0[d:] = 0.0
        for arr, visc, art in ((cw, 0.03, False), (cw0, 1.0, True), (cw, 0.03, True)):
            a_t = convdiff_corner_mats(torch.from_numpy(arr), visc, art_diff=art, ncomp=1)
            a_j = jcorner(jnp.asarray(arr), visc, art_diff=art, ncomp=1)
            assert a_t.shape == (1, 1, d + 1, d + 1, 4, 5) and _rel(a_t, a_j) < 1e-13
        coords = rng.normal(size=(9, d))
        elems = np.stack([rng.permutation(9)[: d + 1] for _ in range(6)])
        w = rng.normal(size=(d, 9))
        for ww, visc, art in ((w, 0.03, False), (0 * w, 1.0, True)):
            e_t = convdiff_elem_mats(torch.from_numpy(coords), torch.from_numpy(elems), torch.from_numpy(ww),
                                     visc, art_diff=art, ncomp=1)
            e_j = jelem(jnp.asarray(coords), jnp.asarray(elems), jnp.asarray(ww), visc, art_diff=art, ncomp=1)
            assert e_t.shape == (1, 1, d + 1, d + 1, 6) and _rel(e_t, e_j) < 1e-13


def test_pcd_tables_and_scalar_base_pattern_match_jax(setup):
    """The scalar level tables carry the inlet-Dirichlet free masks on every
    level, everything else as the patchset's own; the level-0 scalar
    pattern and fixed mask are the JAX pressure space's."""
    prob, ctx = setup["prob"], setup["ctx"]
    assert len(ctx.pcd_tabs) == len(prob._pcd_tabs)
    for t, j in zip(ctx.pcd_tabs, prob._pcd_tabs):
        np.testing.assert_array_equal(t.free.numpy(), np.asarray(j.free))
        np.testing.assert_array_equal(t.owner.numpy(), np.asarray(j.owner))
        np.testing.assert_array_equal(t.gid.numpy(), np.asarray(j.gid))
    pat_t, pat_j = ctx.base0["pat_p"], prob.p_space.patterns[0]
    assert pat_t.block == 1
    np.testing.assert_array_equal(pat_t.cols, pat_j.cols)
    np.testing.assert_array_equal(pat_t.slots, pat_j.slots)
    np.testing.assert_array_equal(ctx.base0["fixed_p"].numpy(), np.asarray(prob.p_space.fixed[0]))
    s = ctx.pcd_struct
    assert (s.smoother, s.smoother_w, s.pre_smooth, s.post_smooth) == ("jacobi", "f32", 2, 2)


def test_pcd_data_matches_jax(setup):
    """W_fp and the Ap hierarchy (per-level full 15- or 7-slot scalar W,
    inverse diagonal, lmax, dense base inverse) and mp, to 1e-12 relative."""
    _, ap_t, Wfp_t, mp_t, _, _ = setup["m_t"]
    ap_j = setup["ap_j"]
    O = 15 if setup["ctx"].ps.dim == 3 else 7
    assert len(ap_t.W) == len(ap_j.W)
    for l in range(len(ap_t.W)):
        assert ap_t.W[l].shape[:3] == (O, 1, 1)
        assert _rel(ap_t.W[l], ap_j.W[l]) < 1e-12
        assert _rel(ap_t.inv_diag[l], ap_j.inv_diag[l]) < 1e-12
        assert _rel(ap_t.lmax[l], ap_j.lmax[l]) < 1e-12
    assert ap_t.W_sm is None
    assert _rel(ap_t.base_inv, ap_j.base_inv) < 1e-12
    assert Wfp_t.shape == tuple(setup["Wfp_j"].shape) and _rel(Wfp_t, setup["Wfp_j"]) < 1e-12
    assert _rel(mp_t, setup["mp_j"]) < 1e-12
    # adjoint=True negates the advecting field in Fp (kept for parity)
    prob, ctx = setup["prob"], setup["ctx"]
    _, Wfp_a, _ = tns.ns_pcd_precond_data_patch(
        ctx.space, ctx.ps, ctx.pcd_struct, ctx.pcd_tabs, ctx.ap_base_dense_fn, ctx.coords, VISC,
        s=convert.ns_state(setup["s"], "cpu"), adjoint=True)
    _, _, Wfp_aj, _, _ = prob._ns_pre(prob.X0, s=jnp.asarray(setup["s"]), adjoint=True, nu=VISC)
    assert _rel(Wfp_a, Wfp_aj) < 1e-12 and _rel(Wfp_a, Wfp_t) > 1e-3


def test_pcd_data_is_contiguous(setup):
    """The kernel wrappers refuse strided tensors, and elementwise results
    take the strides of their operands: a strided free mask (as
    np.moveaxis leaves it) made the inverse diagonals, and through them the
    fields of the lmax power iteration, strided, and the first scalar
    launch raised on the card.  Every tensor the scalar V-cycle and Fp hand
    to the kernel is contiguous."""
    ctx = setup["ctx"]
    _, ap_t, Wfp_t, _, _, _ = setup["m_t"]
    assert all(t.free.is_contiguous() for t in ctx.pcd_tabs)
    assert all(t.is_contiguous() for t in ap_t.W + ap_t.inv_diag + [Wfp_t])
    tab = ctx.pcd_tabs[-1]
    x = st.to_patch_tab(tab, torch.ones((1, ctx.space.n_pressure), dtype=torch.float64))
    assert (ap_t.inv_diag[-1] * x * tab.free[None]).is_contiguous()


def test_convert_pcd_data_carries_the_jax_state(setup):
    """convert.pcd_data on the JAX package's (ap_data, W_fp, mp): equal
    arrays, scalar free masks included, and the port's Schur action on it
    equals the JAX package's to 1e-10."""
    prob, ctx = setup["prob"], setup["ctx"]
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    ap_c, Wfp_c, mp_c = convert.pcd_data(as_np(setup["ap_j"]), as_np(setup["Wfp_j"]), as_np(setup["mp_j"]),
                                         ctx.ps, "cpu")
    for l, tab in enumerate(ap_c.tabs):
        np.testing.assert_array_equal(tab.free.numpy(), np.asarray(prob._pcd_tabs[l].free))
        np.testing.assert_array_equal(ap_c.W[l].numpy(), np.asarray(setup["ap_j"].W[l]))
    np.testing.assert_array_equal(Wfp_c.numpy(), np.asarray(setup["Wfp_j"]))
    rp = np.random.default_rng(21).normal(size=ctx.space.n_pressure)
    S_c = tns.pcd_schur_patch_M(ctx.space, ctx.ps, ctx.pcd_struct, ap_c.tabs, ap_c, Wfp_c, mp_c)
    assert _rel(S_c(torch.from_numpy(rp)), setup["schur_j"](jnp.asarray(rp))) < 1e-10


def test_patch_fp_apply_matches_jax_ell_assembly(setup):
    """The patch Fp apply (the scalar full-stencil apply, then the exchange)
    against the JAX package's block-ELL assembly of the same operator on
    the free subspace, as tests/test_ns_patchjac.py::
    test_pcd_patch_fp_matches_ell holds the JAX patch form: 1e-12."""
    prob, ctx = setup["prob"], setup["ctx"]
    lvl = ctx.hier.fine
    dim = ctx.space.dim
    rng = np.random.default_rng(2)
    w_p1 = rng.normal(size=(dim, lvl.num_vertices))
    pat = prob.p_space.fine_pattern
    em = jelem(prob.X0, jnp.asarray(lvl.elems), jnp.asarray(w_p1), VISC, art_diff=False, ncomp=1)
    vals = jsparsity.bake_dirichlet(pat, jsparsity.assemble_values(pat, em), jnp.asarray(prob.p_space.fixed[-1]))
    tab = ctx.pcd_tabs[-1]
    cw = torch.cat([ctx.coords.T, torch.from_numpy(w_p1)], dim=0)
    W_fp = st.assemble_w(
        ctx.ps, ctx.ps.k, st.to_patch_tab(tab, cw),
        lambda c: convdiff_corner_mats(c, VISC, art_diff=False, ncomp=1), free=tab.free,
    )
    free_g = (~lvl.vertex_mask(("inlet",))).astype(np.float64)
    x = rng.normal(size=lvl.num_vertices) * free_g
    y_ell = np.asarray(jsparsity.spmv_flat(pat, vals, jnp.asarray(x))) * free_g
    sk.reset_launches()
    y_p = st.exchange_sum(None, st.apply_w(ctx.ps, W_fp, st.to_patch_tab(tab, torch.from_numpy(x)[None])), tab)
    y_patch = st.from_patch_tab(tab, y_p, lvl.num_vertices, mode="owner")[0].numpy() * free_g
    assert sum(sk.launches.values()) == 0
    assert np.linalg.norm(y_patch - y_ell) / np.linalg.norm(y_ell) < 1e-12


def test_schur_action_and_preconditioner_match_jax(setup):
    """pcd_schur_patch_M (fixed components passing through the V-cycle and
    through Fp) and the whole block-triangular ns_pcd_M on a random r, to
    1e-10; two velocity Richardson steps (vel_inner=2) as well."""
    ctx, m_t = setup["ctx"], setup["m_t"]
    _, ap_t, Wfp_t, mp_t, _, _ = m_t
    rng = np.random.default_rng(22)
    rp = rng.normal(size=ctx.space.n_pressure)
    S_t = tns.pcd_schur_patch_M(ctx.space, ctx.ps, ctx.pcd_struct, ctx.pcd_tabs, ap_t, Wfp_t, mp_t)
    zp = S_t(torch.from_numpy(rp))
    assert _rel(zp, setup["schur_j"](jnp.asarray(rp))) < 1e-10
    # on the inlet (Dirichlet of Ap and Fp) the action is r_p / mp
    inlet = ctx.hier.fine.vertex_mask(("inlet",))
    assert inlet.any() and _rel(zp.numpy()[inlet], (rp / mp_t.numpy())[inlet]) < 1e-13
    r = rng.normal(size=ctx.n_state)
    sk.reset_launches()
    assert _rel(ctx.M_fn(torch.from_numpy(r), *m_t), setup["M_j"](jnp.asarray(r))) < 1e-10
    assert sum(sk.launches.values()) == 0


def test_transpose_of_pcd_preconditioner_matches_jax_and_is_exact(setup):
    """transpose_M of ns_pcd_M (the recorded vjp through both V-cycles and
    Fp; every full-W apply's backward is the transposed apply's twin):
    <M x, y> = <x, M^T y> to 1e-10, and equal to the JAX package's jax.vjp
    transpose on the same y to 1e-10."""
    ctx, m_t = setup["ctx"], setup["m_t"]
    rng = np.random.default_rng(23)
    x, y = rng.normal(size=ctx.n_state), rng.normal(size=ctx.n_state)
    M_t = lambda r: ctx.M_fn(r, *m_t)  # noqa: E731
    MT_t = tns.transpose_M(M_t, ctx.n_state, torch.float64, "cpu")
    MT_j = jax.jit(jns.transpose_M(setup["M_j"], ctx.n_state, jnp.float64))
    mty = MT_t(torch.from_numpy(y))
    assert _rel(mty, MT_j(jnp.asarray(y))) < 1e-10
    a = float(torch.dot(M_t(torch.from_numpy(x)), torch.from_numpy(y)))
    b = float(torch.dot(torch.from_numpy(x), mty))
    assert abs(a - b) <= 1e-10 * max(abs(a), abs(b))


def test_build_defaults_to_the_card_and_refuses_without_one():
    """build() of every entry point runs on the card by default: without
    one it raises instead of falling back to the CPU."""
    from admm_optim_tpu_torch import resolve_device, xupdate_solve

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    for fn in (lambda: resolve_device(), lambda: ns_run.build(0, dim=2), lambda: xupdate_solve.build(0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(ValueError, match="pressure_precond"):
        ns_run.build(0, "cpu", dim=2, pressure_precond="amg")
