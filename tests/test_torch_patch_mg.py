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
    bl = _lanes(hier, ps, seed=3)
    vl = jax.jit(jax.vmap(lambda bb: jmg.vcycle_p(struct, data, bb)))(jnp.asarray(bl))
    return dict(
        data=jax.tree_util.tree_map(np.asarray, data), b=np.array(b),
        res=jax.tree_util.tree_map(np.asarray, res), v=np.asarray(v),
        v_jacobi=np.asarray(v_jacobi), b_lanes=bl, v_lanes=np.asarray(vl),
    )


def _lanes(hier, ps, seed, n=5):
    """n consistent free-masked right-hand sides (n, 3, *lat, P), one of
    them zero, from default_rng(seed)."""
    fine = hier.fine
    free = ~fine.vertex_mask(DIRICHLET)
    bg = np.random.default_rng(seed).normal(size=(n, 3, fine.num_vertices)) * free
    bg[2] = 0.0
    return bg[..., np.moveaxis(ps.fine.gid, 0, -1)]


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


def test_batched_vcycle_matches_per_lane_and_jax_vmap(jax_ref, port):
    """vcycle_p on a lane axis (B, C, *lat, P) - one apply launch per
    stencil apply for all lanes - equals the port's per-lane V-cycles and
    jax.vmap of the JAX package's, in float64."""
    bl = torch.from_numpy(jax_ref["b_lanes"])
    vb = patch_mg.vcycle_p(port.struct, port.data, bl)
    assert vb.shape == bl.shape
    per_lane = torch.stack([patch_mg.vcycle_p(port.struct, port.data, b) for b in bl])
    assert _rel(vb, per_lane) <= 1e-12
    assert _rel(vb, jax_ref["v_lanes"]) <= 1e-12
    assert float(vb[2].abs().max()) == 0.0  # the zero lane stays zero


def test_batched_vcycle_bf16_pencil_stream_matches_jax(monkeypatch):
    """The same in float32 with the bf16 pencil smoother stream forced on
    in both packages on the refs=1 fine level (3^3 lattice): the JAX
    V-cycle under jax.vmap reaches the batched pencil kernel
    (_apply_w_pallas_3d_pc_batched, interpret mode) for smoothing and the
    restriction residual, the port's batched V-cycle K3's twin.  The port
    runs on the JAX-assembled state (convert.py), so both sides read the
    same bf16 weights: XLA's jit contracts the f32 assembly into FMAs,
    and a one-ulp f32 difference can move a weight by one bf16 ulp (2^-8).
    float32 summation orders differ, hence 1e-5."""
    monkeypatch.setattr(jmg, "_smoother_stream_on", lambda: True)
    monkeypatch.setattr(jmg, "SMOOTHER_STREAM_MIN_LAT", 3)
    monkeypatch.setattr(patch_mg, "smoother_w_plan", lambda struct, ps, dtype, device: [False, True])
    levels = [jgeomgen.channel_3d()]
    levels.append(jrefine(levels[0]))
    hier = JHierarchy(levels)
    ps = jbuild_patchset(hier)
    coords = jnp.asarray(hier.fine.coords, jnp.float32)
    lvl0 = hier.levels[0]
    pat0 = jsp.build_pattern(lvl0.elems, lvl0.num_vertices, 3)
    fixed0 = np.repeat(lvl0.vertex_mask(DIRICHLET)[None], 3, axis=0)

    def base_dense_fn(coords0):
        em0 = deformation_elem_mats(coords0, jnp.asarray(lvl0.elems), 1.0, 1.0, 1.0)
        v0 = jsp.bake_dirichlet(pat0, jsp.assemble_values(pat0, em0), jnp.asarray(fixed0))
        return jnp.linalg.inv(jsp.to_dense(pat0, v0))

    struct = jmg.PatchMGStructure(ps, pre_smooth=2, post_smooth=2, cheb_lower=0.2)
    data = jax.jit(lambda c, tabs: jmg.assemble_patch_mg(
        ps, struct, c, deformation_corner_block_fn(1.0, 1.0, 1.0), base_dense_fn, tabs=tabs, sym=True,
    ))(coords, jmg.make_level_tables(ps, jnp.float32))
    assert data.W_sm[0] is None and data.W_sm[1].a.dtype == jnp.bfloat16
    bl = _lanes(hier, ps, seed=4).astype(np.float32)
    vl = np.asarray(jax.jit(jax.vmap(lambda bb: jmg.vcycle_p(struct, data, bb)))(jnp.asarray(bl)))

    # the port builds the stream on the levels of the plan
    ctx = xupdate_solve.build(1, "cpu", torch.float32)
    assert ctx.data.W_sm[0] is None and ctx.data.W_sm[1].a.dtype == torch.bfloat16
    assert ctx.data.W_sm[1].a.shape == data.W_sm[1].a.shape
    conv = convert.patch_mg_data(jax.tree_util.tree_map(np.asarray, data), ctx.ps, "cpu")
    sk.reset_launches()
    vb = patch_mg.vcycle_p(ctx.struct, conv, torch.from_numpy(bl))
    assert sum(sk.launches.values()) == 0  # CPU tensors: the twins
    assert vb.dtype == torch.float32 and _rel(vb, vl) <= 1e-5


def test_scalar_jacobi_vcycle_on_full_w_matches_jax():
    """assemble_patch_mg_p and vcycle_p at C = 1 with Jacobi smoothing on a
    full 15-slot nonsymmetric W (the PCD pressure hierarchy's form, here
    with a random advecting field so that W is nonsymmetric), the
    estimate_lmax_p power iterations included, against the JAX package on
    the 3D refs=1 channel with inlet-Dirichlet masks: data to 1e-12, the
    V-cycle to 1e-10, from the port's own assembly and from the converted
    JAX state; no kernel launches on CPU tensors."""
    from admm_optim_tpu.ops.convdiff import convdiff_corner_mats as jcorner
    from admm_optim_tpu.ops.convdiff import convdiff_elem_mats as jelem
    from admm_optim_tpu.solvers import ns_solver as jns
    from admm_optim_tpu_torch import ns_run
    from admm_optim_tpu_torch.ops.convdiff import convdiff_corner_mats

    levels = [jgeomgen.channel_3d()]
    levels.append(jrefine(levels[0]))
    hier = JHierarchy(levels)
    jps = jbuild_patchset(hier)
    jtabs = jns.pcd_patch_tables(hier, jps, jnp.float64)
    jstruct = jmg.PatchMGStructure(jps, pre_smooth=2, post_smooth=2, smoother="jacobi", smoother_w="f32")
    lvl0 = hier.levels[0]
    pat0 = jsp.build_pattern(lvl0.elems, lvl0.num_vertices, 1)
    fixed0 = lvl0.vertex_mask(("inlet",))[None]

    def jbase(arg):
        em = jelem(arg[:, :3], jnp.asarray(lvl0.elems), arg[:, 3:].T, 0.05, ncomp=1)
        v0 = jsp.bake_dirichlet(pat0, jsp.assemble_values(pat0, em), jnp.asarray(fixed0))
        return jnp.linalg.inv(jsp.to_dense(pat0, v0))

    rng = np.random.default_rng(31)
    V = hier.fine.num_vertices
    cw = np.concatenate([hier.fine.coords.T, rng.normal(size=(3, V))], axis=0)
    jdata = jmg.assemble_patch_mg_p(
        jps, jstruct, jst.to_patch(jps.fine, jnp.asarray(cw)), lambda c: jcorner(c, 0.05, ncomp=1), jbase, jtabs)
    free = ~hier.fine.vertex_mask(("inlet",))
    b = (rng.normal(size=(1, V)) * free)[:, np.moveaxis(jps.fine.gid, 0, -1)]
    v_j = np.asarray(jmg.vcycle_p(jstruct, jdata, jnp.asarray(b)))

    ctx = ns_run.build(1, "cpu", torch.float64, visc=0.05, dim=3, pressure_precond="pcd")
    ps, tabs = ctx.ps, ctx.pcd_tabs

    def tbase(arg):
        b0 = ctx.base0
        from admm_optim_tpu_torch.ops import sparsity
        from admm_optim_tpu_torch.ops.convdiff import convdiff_elem_mats

        em = convdiff_elem_mats(arg[:, :3], b0["elems"], arg[:, 3:].T, 0.05, ncomp=1)
        v0 = sparsity.bake_dirichlet(b0["pat_p"], sparsity.assemble_values(b0["pat_p"], em), b0["fixed_p"])
        return torch.linalg.inv(sparsity.to_dense(b0["pat_p"], v0))

    data = patch_mg.assemble_patch_mg_p(
        ps, ctx.pcd_struct, st.to_patch_tab(tabs[-1], torch.from_numpy(cw)),
        lambda c: convdiff_corner_mats(c, 0.05, ncomp=1), tbase, tabs)
    for l in range(len(ps.levels)):
        assert data.W[l].shape[:3] == (15, 1, 1)
        assert _rel(data.W[l], jdata.W[l]) <= 1e-12
        assert _rel(data.inv_diag[l], jdata.inv_diag[l]) <= 1e-12
        assert abs(float(data.lmax[l]) - float(jdata.lmax[l])) <= 1e-12 * float(jdata.lmax[l])
    # nonsymmetric: slot o at s is not slot -o at s+o
    assert _rel(data.W[-1], st.expand_sym_w(ps, data.W[-1][st.half_slots(ps)])) > 1e-3
    assert _rel(data.base_inv, jdata.base_inv) <= 1e-10
    sk.reset_launches()
    bt = torch.from_numpy(b)
    assert _rel(patch_mg.vcycle_p(ctx.pcd_struct, data, bt), v_j) <= 1e-10
    conv = convert.patch_mg_data(jax.tree_util.tree_map(np.asarray, jdata), ps, "cpu")
    assert _rel(patch_mg.vcycle_p(ctx.pcd_struct, conv, bt), v_j) <= 1e-10
    assert sum(sk.launches.values()) == 0


# ---------------------------------------------------------------------------
# the V-cycle's CUDA graphs: what the CPU can show (the key and the gate);
# replays are held to the eager cycle on the card (test_torch_vcycle_graph)
# ---------------------------------------------------------------------------

def test_cpu_cycles_run_eager(port):
    """CPU tensors never capture: every cycle counts as eager, data keeps
    no graph, and each mg.vcycle span says graph="eager"."""
    from admm_optim_tpu_torch.utils import profiling

    b = xupdate_solve.random_rhs(port, seed=2)
    data = dataclasses.replace(port.data)
    patch_mg.reset_graph_counts()
    x = [patch_mg.vcycle_p(port.struct, data, b) for _ in range(3)]
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        res = patch_mg.cg_p(port.struct, data, b, max_iters=5, rel_tol=1e-4)
    recs = [r for r in profiling.spans() if r["name"] == "mg.vcycle"]
    profiling.reset_spans()
    n = 3 + int(res.iters) + 1
    assert patch_mg.graph_counts == {"eager": n, "capture": 0, "replay": 0}
    assert data.graphs is None
    assert len(recs) == n - 3 and all(r["attrs"] == {"graph": "eager"} for r in recs)
    assert torch.equal(x[0], x[2])


def test_cycle_key_follows_storage(port):
    """The key changes when a W or W_sm entry is replaced, when data is
    assembled anew and with the structure's settings; it stays the same
    for writes into the same storage."""
    ps, struct = port.ps, port.struct
    data = dataclasses.replace(port.data, W=[w.clone() for w in port.data.W],
                               inv_diag=[v.clone() for v in port.data.inv_diag])
    assert data.graphs is None
    key = patch_mg.cycle_key(struct, data)
    assert patch_mg.cycle_key(struct, data) == key
    assert patch_mg.cycle_key(struct, port.data) != key  # another copy of the operator
    data.W[1].mul_(2.0)
    data.inv_diag[0].add_(1.0)
    assert patch_mg.cycle_key(struct, data) == key
    data.W[1] = data.W[1].clone()
    k2 = patch_mg.cycle_key(struct, data)
    assert k2 != key
    pencil = st.PencilW(sk.to_pencil_major(ps, data.W[ps.k], torch.bfloat16))
    data.W_sm = [None] * ps.k + [pencil]
    k3 = patch_mg.cycle_key(struct, data)
    assert k3 != k2
    pencil.a.zero_()
    assert patch_mg.cycle_key(struct, data) == k3
    data.W_sm[ps.k] = st.PencilW(pencil.a.clone())
    assert patch_mg.cycle_key(struct, data) != k3
    again = xupdate_solve.assemble(port, torch.as_tensor(port.hier.fine.coords, dtype=torch.float64))
    assert patch_mg.cycle_key(struct, again) != patch_mg.cycle_key(struct, port.data)
    assert patch_mg.cycle_key(dataclasses.replace(struct, pre_smooth=3), port.data) != \
        patch_mg.cycle_key(struct, port.data)


@pytest.mark.parametrize("case", ["cpu", "spmd", "x0", "b_grad", "data_grad", "capturing"])
def test_graph_gate_leaves_calls_eager(port, monkeypatch, case):
    """_graph_mode with b taken for a CUDA tensor: a CPU tensor, a sharded
    cycle, a given x0, an input or a data tensor that requires grad, and a
    call inside another capture run eagerly and leave data without a
    graph; the same call otherwise runs eagerly once (the warm-up), then
    captures, or stays eager while a profiler records, and a replaced W
    entry starts that over."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: case == "capturing")
    if case != "cpu":
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    struct = port.struct
    data = dataclasses.replace(port.data, W=list(port.data.W), inv_diag=list(port.data.inv_diag))
    b = xupdate_solve.random_rhs(port, seed=3)
    x0 = None
    if case == "spmd":
        struct = dataclasses.replace(struct, spmd=st.SpmdCtx(group=None, rank=0, nshards=1))
    elif case == "x0":
        x0 = torch.zeros_like(b)
    elif case == "b_grad":
        b.requires_grad_()
    elif case == "data_grad":
        data.inv_diag[1] = data.inv_diag[1].clone().requires_grad_()
    for _ in range(3):
        assert patch_mg._graph_mode(struct, data, b, x0) == ("eager", None)
    assert data.graphs is None
    # the same call, eligible
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    b = b.detach()
    data.inv_diag[1] = data.inv_diag[1].detach()
    at = (b.shape, b.stride(), b.dtype, b.device)
    assert patch_mg._graph_mode(port.struct, data, b, None) == ("eager", None)
    assert data.graphs["cycles"] == {at: "warm"}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert patch_mg._graph_mode(port.struct, data, b, None) == ("eager", at)
    assert patch_mg._graph_mode(port.struct, data, b, None) == ("capture", at)
    data.W[1] = data.W[1].clone()
    assert patch_mg._graph_mode(port.struct, data, b, None) == ("eager", None)
    assert data.graphs["key"] == patch_mg.cycle_key(port.struct, data)
