"""The port's patch multigrid against the JAX package: the V-cycle and the
solvers fed JAX-assembled state (convert.py), and the slice as a whole -
xupdate_solve.build + solve against the JAX cg_ir_p with bench.py's
settings at 3D refs=1 in float64."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy
from admm_optim_tpu.core.mesh import refine as jrefine
from admm_optim_tpu.core.patches import build_patchset as jbuild_patchset
from admm_optim_tpu.ops import patchstencil as jst
from admm_optim_tpu.ops import sparsity as jsp
from admm_optim_tpu.ops.deformation import deformation_corner_block_fn, deformation_elem_mats
from admm_optim_tpu.solvers import patch_mg as jmg
from admm_optim_tpu_torch import convert, xupdate_solve
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.solvers import patch_mg

torch.set_num_threads(1)

DIRICHLET = ("inlet", "wall", "outlet")


@pytest.fixture(scope="module")
def jax_ref():
    """bench.py's assemble_ctx + cg_ir_p at 3D refs=1, float64, with the
    JAX package (refs=1 keeps the lane's time: ~30 s on one CPU core)."""
    levels = [jgeomgen.channel_3d()]
    levels.append(jrefine(levels[0]))
    hier = JHierarchy(levels)
    ps = jbuild_patchset(hier)
    coords = jnp.asarray(hier.fine.coords)
    lvl0 = hier.levels[0]
    pat0 = jsp.build_pattern(lvl0.elems, lvl0.num_vertices, 3)
    fixed0 = np.repeat(lvl0.vertex_mask(DIRICHLET)[None], 3, axis=0)

    def base_dense_fn(coords0):
        em0 = deformation_elem_mats(coords0, jnp.asarray(lvl0.elems), 1.0, 1.0, 1.0)
        v0 = jsp.bake_dirichlet(pat0, jsp.assemble_values(pat0, em0), jnp.asarray(fixed0))
        return jnp.linalg.inv(jsp.to_dense(pat0, v0))

    struct = jmg.PatchMGStructure(ps, pre_smooth=2, post_smooth=2, cheb_lower=0.2)
    data = jmg.assemble_patch_mg(
        ps, struct, coords, deformation_corner_block_fn(1.0, 1.0, 1.0), base_dense_fn,
        tabs=jmg.make_level_tables(ps, coords.dtype), sym=True,
    )
    rng = np.random.default_rng(0)
    b_g = rng.normal(size=(3, hier.fine.num_vertices)) * (~hier.fine.vertex_mask(DIRICHLET))[None]
    b = jst.to_patch(ps.fine, jnp.asarray(b_g))
    res = jmg.cg_ir_p(struct, data, b, **xupdate_solve.SOLVE_SETTINGS)
    v = jmg.vcycle_p(struct, data, b)
    v_jacobi = jmg.vcycle_p(dataclasses.replace(struct, smoother="jacobi"), data, b)
    return dict(
        data=jax.tree_util.tree_map(np.asarray, data), b=np.array(b),
        res=jax.tree_util.tree_map(np.asarray, res), v=np.asarray(v),
        v_jacobi=np.asarray(v_jacobi),
    )


@pytest.fixture(scope="module")
def port():
    return xupdate_solve.build(1, "cpu", torch.float64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_slice_matches_jax_cg_ir_p(jax_ref, port):
    """The port's own host mesh, assembly and solve against the JAX
    package: the same right-hand side, the same inner CG iteration count
    and IR rounds and flag, and x within 1e-9."""
    b = xupdate_solve.random_rhs(port, seed=0)
    np.testing.assert_array_equal(b.numpy(), jax_ref["b"])
    jd = jax_ref["data"]
    for l in range(len(port.ps.levels)):
        assert _rel(port.data.W[l], jd.W[l]) <= 1e-12
        assert _rel(port.data.inv_diag[l], jd.inv_diag[l]) <= 1e-12
        assert abs(float(port.data.lmax[l]) - float(jd.lmax[l])) <= 1e-12 * float(jd.lmax[l])
    assert _rel(port.data.base_inv, jd.base_inv) <= 1e-10
    assert port.data.W_sm is None  # CPU: no bf16 smoother stream
    res = xupdate_solve.solve(port, b)
    jres = jax_ref["res"]
    assert res.inner_iters == int(jres.inner_iters) == 13
    assert res.rounds == int(jres.rounds) == 2
    assert res.converged and bool(jres.converged)
    x = (res.x_hi + res.x_lo).numpy()
    assert _rel(x, jres.x_hi + jres.x_lo) <= 1e-9


def test_vcycle_and_solve_from_converted_state(jax_ref, port):
    """JAX-assembled PatchMGData -> convert -> the port's V-cycle and
    cg_ir_p, separately from the port's own assembly."""
    data = convert.patch_mg_data(jax_ref["data"], port.ps, "cpu")
    b = torch.from_numpy(jax_ref["b"])
    v = patch_mg.vcycle_p(port.struct, data, b)
    assert _rel(v, jax_ref["v"]) <= 1e-10
    jacobi = dataclasses.replace(port.struct, smoother="jacobi")
    assert _rel(patch_mg.vcycle_p(jacobi, data, b), jax_ref["v_jacobi"]) <= 1e-10
    res = patch_mg.cg_ir_p(port.struct, data, b, **xupdate_solve.SOLVE_SETTINGS)
    jres = jax_ref["res"]
    assert (res.inner_iters, res.rounds, res.converged) == (
        int(jres.inner_iters), int(jres.rounds), bool(jres.converged))
    assert _rel(res.x_hi + res.x_lo, jres.x_hi + jres.x_lo) <= 1e-9
    # the converted tables are the port's own tables
    for t_conv, t_own in zip(data.tabs, port.data.tabs):
        for f in dataclasses.fields(t_own):
            a, o = getattr(t_conv, f.name), getattr(t_own, f.name)
            if isinstance(o, tuple):
                assert len(a) == len(o) and all(torch.equal(u, w) for u, w in zip(a, o))
            elif isinstance(o, torch.Tensor):
                assert torch.equal(a, o), f.name
            else:
                assert a == o, f.name


def test_bf16_pencil_smoother_stream():
    """The bf16 pencil smoother stream (built on the GPU for levels with a
    lattice edge >= 9) driven through K2's twin on the CPU at refs=2, as
    tests/test_df.py::test_bf16_smoother_stream_interpret_mode drives the
    JAX one: the V-cycle still contracts and cg_ir_p still reaches a true
    float64-evaluated residual below 2e-9."""
    ctx = xupdate_solve.build(2, "cpu", torch.float32)
    ps, data = ctx.ps, ctx.data
    data.W_sm = [None] * ps.k + [st.PencilW(sk.to_pencil_major(ps, data.W[ps.k], torch.bfloat16))]
    assert data.smoother_W(ps.k).dtype == torch.bfloat16
    b = xupdate_solve.random_rhs(ctx, seed=5)
    tab = data.tabs[ps.k]
    W64 = data.W[ps.k].double()
    b64 = b.double()

    def true_rel_res(x64):
        y = st.exchange_sum(None, sk._apply_w_sym(ps, W64, x64), tab)
        r = (b64 - y) * tab.free.double()[None]
        return float(torch.sqrt(st.owner_dot(None, r, r, tab) / st.owner_dot(None, b64, b64, tab)))

    assert true_rel_res(patch_mg.vcycle_p(ctx.struct, data, b).double()) < 0.5
    res = patch_mg.cg_ir_p(ctx.struct, data, b, rel_tol=1e-9, max_rounds=8, inner_rel=1e-4, inner_iters=60)
    assert res.converged
    assert true_rel_res(res.x_hi.double() + res.x_lo.double()) < 2e-9


def test_smoother_plan_and_cost_table(port):
    ps = port.ps
    # the bf16 stream needs a CUDA device, float32, and lattice edge >= 9
    assert patch_mg.smoother_w_plan(port.struct, ps, torch.float32, "cpu") is None
    assert patch_mg.smoother_w_plan(port.struct, ps, torch.float64, "cuda") is None
    assert patch_mg.smoother_w_plan(port.struct, ps, torch.float32, "cuda") is None  # 3^3
    lat9 = dataclasses.replace(ps.fine, gid=np.zeros((ps.P, 9, 9, 9), np.int32))
    ps9 = dataclasses.replace(ps, levels=ps.levels + [lat9])
    assert patch_mg.smoother_w_plan(port.struct, ps9, torch.float32, "cuda") == [False, False, True]
    f32 = dataclasses.replace(port.struct, smoother_w="f32")
    assert patch_mg.smoother_w_plan(f32, ps9, torch.float32, "cuda") is None
    # the roofline bandwidth is the caller's: no default
    with pytest.raises(TypeError):
        patch_mg.vcycle_cost_table(port.struct, port.data)
    table = patch_mg.vcycle_cost_table(port.struct, port.data, 3350.0)
    assert "@ 3350 GB/s" in table and len(table.splitlines()) == len(ps.levels) + 2
