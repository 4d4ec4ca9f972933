"""Port of the patch-stencil operators against the JAX package on the same
inputs: assembly (block and dense protocols), the symmetric apply's plain
twin and the segment-sum exchange in float64, the error-free DF exchange
bit for bit in float32, the MG transfers, the global glue and the level-0
base operator."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy
from admm_optim_tpu.core.mesh import refine as jrefine
from admm_optim_tpu.core.patches import build_patchset as jbuild_patchset
from admm_optim_tpu.ops import deformation as jdef
from admm_optim_tpu.ops import patchstencil as jst
from admm_optim_tpu.ops import sparsity as jsp
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset
from admm_optim_tpu_torch.ops import deformation as tdef
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import sparsity as tsp
from admm_optim_tpu_torch.ops import stencil_kernels as sk

torch.set_num_threads(1)


def _both(refs, n_side=(2, 1, 1)):
    """(JAX hierarchy, patchset), (port hierarchy, patchset) of one mesh."""
    jl = [jgeomgen.channel_3d(n_side=n_side)]
    tl = [geomgen.channel_3d(n_side=n_side)]
    for _ in range(refs):
        jl.append(jrefine(jl[-1]))
        tl.append(refine(tl[-1]))
    jh, th = JHierarchy(jl), Hierarchy(tl)
    return (jh, jbuild_patchset(jh)), (th, build_patchset(th))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("refs", [1, 2])
def test_assemble_w_sym_block_protocol_matches_jax(refs):
    (jh, jps), (th, tps) = _both(refs)
    cp = th.fine.coords.T
    jcp = jst.to_patch(jps.fine, jnp.asarray(cp))
    tcp = st.to_patch(tps.fine, _t(cp))
    np.testing.assert_array_equal(tcp.numpy(), np.asarray(jcp))
    free = tps.fine.free
    Wj = jst.assemble_w(
        jps, jps.k, jcp, jdef.deformation_corner_block_fn(1.0, 2.0, 0.5),
        sym=True, free=jnp.asarray(free, jnp.float64),
    )
    Wt = st.assemble_w(
        tps, tps.k, tcp, tdef.deformation_corner_block_fn(1.0, 2.0, 0.5),
        sym=True, free=_t(free),
    )
    assert Wt.shape == Wj.shape == (8, 3, 3) + tps.fine.lat_shape + (tps.P,)
    assert _rel(Wt, Wj) <= 1e-12
    # the symmetric half expands to the JAX package's full stencil
    assert _rel(st.expand_sym_w(tps, Wt), jst.expand_sym_w(jps, Wj)) <= 1e-12
    # stencil diagonal and the separate Dirichlet bake
    assert _rel(st.stencil_diag(tps, tps.k, Wt), jst.stencil_diag(jps, jps.k, Wj)) <= 1e-12


def test_assemble_w_dense_protocol_and_bake_match_jax():
    (jh, jps), (th, tps) = _both(2)
    cp = th.fine.coords.T
    jcp = jst.to_patch(jps.fine, jnp.asarray(cp))
    tcp = st.to_patch(tps.fine, _t(cp))
    Wj = jst.assemble_w(jps, jps.k, jcp, lambda x: jdef.deformation_corner_mats(x, 1.0, 2.0, 0.5))
    Wt = st.assemble_w(tps, tps.k, tcp, lambda x: tdef.deformation_corner_mats(x, 1.0, 2.0, 0.5))
    assert Wt.shape[0] == 15
    assert _rel(Wt, Wj) <= 1e-12
    assert _rel(st.bake_dirichlet_w(tps, tps.k, Wt), jst.bake_dirichlet_w(jps, jps.k, Wj)) <= 1e-12


def _sym_problem(refs, dtype):
    (jh, jps), (th, tps) = _both(refs)
    cp = th.fine.coords.T
    jcp = jst.to_patch(jps.fine, jnp.asarray(cp, dtype))
    fn = jdef.deformation_corner_block_fn(1.0, 1.0, 1.0)
    Wj = jst.assemble_w(jps, jps.k, jcp, fn, sym=True, free=jnp.asarray(jps.fine.free, dtype))
    return jh, jps, th, tps, np.asarray(Wj)


@pytest.mark.parametrize("refs", [1, 2])
def test_apply_w_sym_twin_and_exchange_match_jax_f64(refs):
    jh, jps, th, tps, W = _sym_problem(refs, jnp.float64)
    rng = np.random.default_rng(refs)
    x = rng.normal(size=(3,) + tps.fine.lat_shape + (tps.P,))
    jtab = jst.make_tables(jps.fine, jnp.float64)
    ttab = st.make_tables(tps.fine, torch.float64)
    yj = jst.exchange_sum(None, jst._apply_w_sym(jps, jnp.asarray(W), jnp.asarray(x)), jtab)
    yt_add = sk._apply_w_sym(tps, _t(W), _t(x))
    assert _rel(yt_add, jst._apply_w_sym(jps, jnp.asarray(W), jnp.asarray(x))) <= 1e-13
    # the dispatching apply_w takes the twin for CPU tensors
    assert torch.equal(st.apply_w(tps, _t(W), _t(x)), yt_add)
    yt = st.exchange_sum(None, yt_add, ttab)
    assert _rel(yt, yj) <= 1e-13
    # exchange alone, on an additive random vector
    assert _rel(st.exchange_sum(tps.fine, _t(x)), jst.exchange_sum(jps.fine, jnp.asarray(x))) <= 1e-13
    # owner-weighted inner product of consistent vectors
    dj = float(jst.owner_dot(None, yj, yj, jtab))
    dt = float(st.owner_dot(None, yt, yt, ttab))
    assert abs(dt - dj) <= 1e-13 * abs(dj)


@pytest.mark.parametrize("refs", [1, 2])
def test_exchange_sum_df_bit_equal_to_jax(refs):
    (jh, jps), (th, tps) = _both(refs)
    lvl = tps.fine
    rng = np.random.default_rng(10 + refs)
    shape = (3,) + lvl.lat_shape + (lvl.P,)
    xh = rng.normal(size=shape).astype(np.float32)
    xl = (rng.normal(size=shape) * 1e-8).astype(np.float32)
    jh_, jl_ = jst.exchange_sum_df(jst.make_tables(jps.fine, jnp.float32), jnp.asarray(xh), jnp.asarray(xl))
    th_, tl_ = st.exchange_sum_df(st.make_tables(lvl, torch.float32), torch.from_numpy(xh), torch.from_numpy(xl))
    np.testing.assert_array_equal(th_.numpy(), np.asarray(jh_))
    np.testing.assert_array_equal(tl_.numpy(), np.asarray(jl_))


def test_prolong_restrict_and_glue_exact():
    (jh, jps), (th, tps) = _both(2)
    rng = np.random.default_rng(3)
    for lc in range(tps.k):
        latc = tps.levels[lc].lat_shape
        latf = tps.levels[lc + 1].lat_shape
        xc = rng.normal(size=(3,) + latc + (tps.P,))
        rf = rng.normal(size=(3,) + latf + (tps.P,))
        np.testing.assert_array_equal(
            st.prolong_p(tps, lc, _t(xc)).numpy(), np.asarray(jst.prolong_p(jps, lc, jnp.asarray(xc)))
        )
        np.testing.assert_array_equal(
            st.restrict_p(tps, lc, _t(rf)).numpy(), np.asarray(jst.restrict_p(jps, lc, jnp.asarray(rf)))
        )
    # to_patch / from_patch (owner and sum) and the table forms
    V = th.fine.num_vertices
    vg = rng.normal(size=(3, V))
    xp = st.to_patch(tps.fine, _t(vg))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jst.to_patch(jps.fine, jnp.asarray(vg))))
    tab = st.make_tables(tps.fine, torch.float64)
    np.testing.assert_array_equal(st.to_patch_tab(tab, _t(vg)).numpy(), xp.numpy())
    np.testing.assert_array_equal(st.from_patch(tps.fine, xp, V).numpy(), vg)
    np.testing.assert_array_equal(st.from_patch_tab(tab, xp, V).numpy(), vg)
    ys = rng.normal(size=xp.shape)
    assert _rel(
        st.from_patch(tps.fine, _t(ys), V, mode="sum"),
        jst.from_patch(jps.fine, jnp.asarray(ys), V, mode="sum"),
    ) <= 1e-14


def test_level0_base_operator_matches_jax():
    """Element matrices, ELL pattern, assembly, Dirichlet bake and the dense
    form of the level-0 operator that the base solve inverts."""
    (jh, jps), (th, tps) = _both(0, n_side=(4, 2, 2))
    lvl0 = th.levels[0]
    pat_j = jsp.build_pattern(lvl0.elems, lvl0.num_vertices, 3)
    pat_t = tsp.build_pattern(lvl0.elems, lvl0.num_vertices, 3)
    for f in ("cols", "slots", "diag_k"):
        np.testing.assert_array_equal(getattr(pat_t, f), getattr(pat_j, f))
    fixed = np.repeat(lvl0.vertex_mask(("inlet", "wall", "outlet"))[None], 3, axis=0)
    emj = jdef.deformation_elem_mats(jnp.asarray(lvl0.coords), jnp.asarray(lvl0.elems), 1.0, 2.0, 0.5)
    emt = tdef.deformation_elem_mats(_t(lvl0.coords), torch.as_tensor(lvl0.elems.astype(np.int64)), 1.0, 2.0, 0.5)
    assert _rel(emt, emj) <= 1e-12
    vj = jsp.bake_dirichlet(pat_j, jsp.assemble_values(pat_j, emj), jnp.asarray(fixed))
    vt = tsp.bake_dirichlet(pat_t, tsp.assemble_values(pat_t, emt), torch.as_tensor(fixed))
    assert _rel(vt, vj) <= 1e-12
    Dj = np.asarray(jsp.to_dense(pat_j, vj))
    Dt = tsp.to_dense(pat_t, vt)
    assert _rel(Dt, Dj) <= 1e-12
    assert _rel(torch.linalg.inv(Dt), np.linalg.inv(Dj)) <= 1e-10
