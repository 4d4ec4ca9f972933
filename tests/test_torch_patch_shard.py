"""The sharded patch multigrid and ADMM inner loop (parallel.patch_shard)
against the single-device port and the JAX package's single-device
functions on the same padded patch set (the torch twin of
tests/test_patch_shard.py).

Ranks are gloo processes on the CPU (parallel.launch), float64: the 2D
channel_2d(n_side=(3, 2), diag="fixed") at refs=2 on 4 ranks (P 34 -> 36,
so the padding is exercised) and the 3D channel_3d(n_side=(2, 1, 1)) at
refs=1 on 2 ranks (P 44).  Each fixture spawns its ranks once
(tests/torch_shard_ranks.py runs every piece) and the tests read what rank
0 gathered.  The exchanges sum each duplicate group from the same members
in the same order as the single device, so they are equal bit for bit;
the dots of the solvers sum per rank before the all-reduce, so the
iterates part from the single device's by rounding: the counts must be
equal, x within 1e-12 of max |x|.  The JAX package's assembly, V-cycle,
cg_p, cg_ir_p and admm_inner_ops (pvalid masking the padding) on the same
inputs take minutes to compile on one CPU core, so they are read from
tests/goldens/e2e_shard.npz (tests/goldens/make_e2e_goldens.py shard).
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_ranks as R
from admm_optim_tpu.core.patches import pad_patchset as jpad_patchset
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy, refine as jrefine
from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.patches import build_patchset as jbuild_patchset
from admm_optim_tpu.ops import patchstencil as jst
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.optim import admm
from admm_optim_tpu_torch.optim.spaces import PatchOps
from admm_optim_tpu_torch.parallel import launch
from admm_optim_tpu_torch.solvers import patch_mg as pmg
from admm_optim_tpu_torch.xupdate_solve import assemble_deformation_p

torch.set_num_threads(1)

TIMEOUT_S = 240.0
GOLDEN = pathlib.Path(__file__).resolve().parent / "goldens" / "e2e_shard.npz"


def _single(c: R.Case):
    """The single-device port on the padded patch set: every piece the
    ranks run."""
    ps = c.ps_pad
    tabs = pmg.make_level_tables(ps, torch.float64)
    out = {"exchange": [st.exchange_sum(None, torch.from_numpy(x), t).numpy() for x, t in zip(c.x_add, tabs)]}
    x = torch.from_numpy(c.x_add[-1])
    out["exchange_groups"] = st.exchange_groups(tabs[-1], x.reshape(-1, tabs[-1].owner.numel())).reshape(x.shape).numpy()
    yh, yl = st.exchange_sum_df(tabs[-1], torch.from_numpy(c.xh), torch.from_numpy(c.xl))
    out["df"] = (yh.numpy(), yl.numpy())
    y = torch.from_numpy(c.x_add[-1][::-1].copy())
    out["owner_dot"] = float(st.owner_dot(None, x, y, tabs[-1]))
    out["owner_dot_lanes"] = st.owner_dot(None, torch.stack([x, y]), torch.stack([y, y]), tabs[-1]).numpy()
    out["from_patch_tab"] = st.from_patch_tab(tabs[-1], x, c.hier.fine.num_vertices).numpy()
    struct = pmg.PatchMGStructure(ps)
    coords_p = st.to_patch(ps.fine, torch.from_numpy(c.hier.fine.coords.T.copy()))
    data = assemble_deformation_p(ps, struct, c.hier.levels[0], coords_p, tabs, R.ADMM_CFG)
    out["data"] = data
    b = st.to_patch(ps.fine, torch.from_numpy(c.b))
    out["vcycle"] = pmg.vcycle_p(struct, data, b).numpy()
    res = pmg.cg_p(struct, data, b, **R.CG)
    out["cg"] = dict(iters=int(res.iters), converged=bool(res.converged), x=res.x.numpy())
    ir = pmg.cg_ir_p(struct, data, b, **R.IR)
    out["ir"] = dict(rounds=ir.rounds, inner_iters=ir.inner_iters, converged=ir.converged,
                     x=(ir.x_hi + ir.x_lo).numpy())
    pvalid = torch.as_tensor((np.arange(ps.P) < c.ps.P).astype(np.float64))
    ops_ = PatchOps(struct, data, coords_p, pvalid=pvalid)
    Jp = st.to_patch(ps.fine, torch.from_numpy(c.Jp))
    out["admm"] = admm.admm_inner(R.ADMM_CFG, ops_, Jp, R.SIGMA, 1.0, torch.tensor(c.ref_vol),
                                  torch.as_tensor(c.ref_bary))
    return out


@pytest.fixture(scope="module", params=list(R.CASES))
def run(request):
    dim, refs, ranks = R.CASES[request.param]
    c = R.case(dim, refs, ranks)
    sharded = launch.spawn(R.shard_rank, ranks, "gloo", "cpu", TIMEOUT_S, c)[0]
    return c, sharded, _single(c)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_padding_is_exercised(run):
    """P padded to the ranks; pad_field puts zeros on the padding."""
    c, sh, _ = run
    assert c.ps_pad.P % c.ranks == 0 and sh["P_local"] * c.ranks == c.ps_pad.P
    if c.ps.dim == 2:
        assert (c.ps.P, c.ps_pad.P) == (34, 36)
    want = c.x_add[-1].copy()
    want[..., c.ps.P :] = 0.0
    np.testing.assert_array_equal(sh["pad_field"], want)


def test_sharded_exchange_matches(run):
    """Every level bit for bit against the single-device port, and within
    1e-12 of the JAX package's exchange on the same padded set."""
    c, sh, one = run
    levels = [jgeomgen.channel_2d(n_side=(3, 2), diag="fixed") if c.ps.dim == 2
              else jgeomgen.channel_3d(n_side=(2, 1, 1))]
    for _ in range(c.ps.k):
        levels.append(jrefine(levels[-1]))
    jps = jpad_patchset(jbuild_patchset(JHierarchy(levels)), c.ranks)
    for l, (got, want) in enumerate(zip(sh["exchange"], one["exchange"])):
        np.testing.assert_array_equal(got, want, err_msg=f"level {l}")
        jw = np.asarray(jst.exchange_sum(None, jnp.asarray(c.x_add[l]), jst.make_tables(jps.levels[l], jnp.float64)))
        assert np.abs(got - jw).max() <= 1e-12 * np.abs(jw).max(), l


def test_sharded_exchange_groups_bit_equal(run):
    """The GPU form (exchange_groups, fixed-order group sums) on a rank's
    tables over its sites and the all-reduced members equals the
    single-device form bit for bit."""
    _, sh, one = run
    np.testing.assert_array_equal(sh["exchange_groups"], one["exchange_groups"])


def test_sharded_df_exchange_bit_equal(run):
    _, sh, one = run
    for got, want in zip(sh["df"], one["df"]):
        np.testing.assert_array_equal(got, want)


def test_owner_dot_and_from_patch_tab(run):
    """The dots sum per rank before the all-reduce (rounding apart); the
    owner-picked global vector has one nonzero copy per vertex (exact)."""
    _, sh, one = run
    assert abs(sh["owner_dot"] - one["owner_dot"]) <= 1e-13 * abs(one["owner_dot"])
    assert _rel(sh["owner_dot_lanes"], one["owner_dot_lanes"]) <= 1e-13
    np.testing.assert_array_equal(sh["from_patch_tab"], one["from_patch_tab"])


@pytest.mark.parametrize("rb", [0, 1])
def test_sharded_assembly_matches(run, rb):
    """Each rank's stencils, inverse diagonals, lambda_max (the power
    iteration from the global flat index) and base inverse, gathered,
    against the single device's; rb=1 agglomerates level 0."""
    _, sh, one = run
    data = one["data"]
    for l in range(len(data.W)):
        assert _rel(sh[f"W{rb}"][l], data.W[l].numpy()) <= 1e-14, l
        assert _rel(sh[f"inv_diag{rb}"][l], data.inv_diag[l].numpy()) <= 1e-14, l
        assert abs(sh[f"lmax{rb}"][l] - float(data.lmax[l])) <= 1e-10 * float(data.lmax[l]), l
    assert _rel(sh[f"base_inv{rb}"], data.base_inv.numpy()) <= 1e-12


@pytest.mark.parametrize("rb", [0, 1])
def test_sharded_vcycle_matches(run, rb):
    """One V-cycle: exchanges and base solve as the single device's, the
    Chebyshev bounds from all-reduced power iterations (rounding apart)."""
    _, sh, one = run
    assert _rel(sh[f"vcycle{rb}"], one["vcycle"]) <= 1e-13


@pytest.mark.parametrize("rb", [0, 1])
def test_sharded_mg_solve_matches(run, rb):
    _, sh, one = run
    got, want = sh[f"cg{rb}"], one["cg"]
    assert got["converged"] and want["converged"]
    assert got["iters"] == want["iters"]
    assert _rel(got["x"], want["x"]) <= 1e-12


@pytest.mark.parametrize("rb", [0, 1])
def test_sharded_ir_solve_matches(run, rb):
    _, sh, one = run
    got, want = sh[f"ir{rb}"], one["ir"]
    assert got["converged"] and want["converged"]
    assert (got["rounds"], got["inner_iters"]) == (want["rounds"], want["inner_iters"])
    assert _rel(got["x"], want["x"]) <= 1e-12


def test_sharded_admm_matches_single_device(run):
    """The ADMM inner loop on the ranks' blocks against the single device
    on the padded set (pvalid masking the padding): the same counts,
    flags and per-lane Krylov counts; u, the dual tensor and Lambda within
    1e-10 of their largest entry, the Krylov solves' rounding apart grown
    by the Newton updates."""
    _, sh, one = run
    got, want = sh["admm"], one["admm"]
    assert (got["admm_it"], got["total_newton"], got["total_lin_iters"]) == (
        want.admm_it, want.total_newton, want.total_lin_iters)
    assert got["solver_iters"] == want.solver_iters
    assert (got["converged"], got["failed"]) == (want.converged, want.failed)
    assert want.total_newton > 0
    for name, w in (("u", want.u), ("lam", want.lam), ("Lambda", want.Lambda)):
        assert _rel(got[name], w.numpy()) <= 1e-10, name
    for name in ("u_diff_norm", "lam_inc_norm", "max_grad_norm"):
        assert abs(got[name] - getattr(want, name)) <= 1e-10 * abs(getattr(want, name)), name


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _jax(c: R.Case, golden) -> dict:
    """The JAX package's single-device results for c, after checking that
    they were made from c's padded set and inputs."""
    name = f"{c.ps.dim}d"
    g = {k[len(name) + 1 :]: golden[k] for k in golden.files if k.startswith(name + "_")}
    assert int(g["P"]) == c.ps_pad.P
    np.testing.assert_array_equal(g["b"], c.b)
    np.testing.assert_array_equal(g["Jp"], c.Jp)
    return g


@pytest.mark.parametrize("rb", [0, 1])
def test_sharded_assembly_matches_jax(run, golden, rb):
    """The ranks' stencils, inverse diagonals, lambda_max and base inverse,
    gathered, against the JAX package's assemble_patch_mg_p on the padded
    set."""
    c, sh, _ = run
    g = _jax(c, golden)
    for l in range(len(c.ps_pad.levels)):
        assert _rel(sh[f"W{rb}"][l], g[f"W{l}"]) <= 1e-12, l
        assert _rel(sh[f"inv_diag{rb}"][l], g[f"inv_diag{l}"]) <= 1e-12, l
        assert abs(sh[f"lmax{rb}"][l] - g["lmax"][l]) <= 1e-10 * g["lmax"][l], l
    assert _rel(sh[f"base_inv{rb}"], g["base_inv"]) <= 1e-10


@pytest.mark.parametrize("rb", [0, 1])
def test_sharded_solves_match_jax(run, golden, rb):
    """One V-cycle, cg_p and cg_ir_p against the JAX package's: the same
    counts and flags, the results within 1e-12 of their largest entry
    (they read 1e-15 apart)."""
    c, sh, _ = run
    g = _jax(c, golden)
    assert _rel(sh[f"vcycle{rb}"], g["vcycle"]) <= 1e-12
    cg, ir = sh[f"cg{rb}"], sh[f"ir{rb}"]
    assert (cg["iters"], cg["converged"]) == (int(g["cg_iters"]), bool(g["cg_converged"]))
    assert _rel(cg["x"], g["cg_x"]) <= 1e-12
    assert (ir["rounds"], ir["inner_iters"], ir["converged"]) == (
        int(g["ir_rounds"]), int(g["ir_inner_iters"]), bool(g["ir_converged"]))
    assert _rel(ir["x"], g["ir_x"]) <= 1e-12


def test_sharded_admm_matches_jax(run, golden):
    """The sharded ADMM inner loop against the JAX package's admm_inner_ops
    on a PatchOps with pvalid: the same counts, per-lane Krylov counts and
    flags; u, the dual tensor and Lambda within 1e-9 of their largest
    entry, as tests/test_torch_admm.py holds the single-device port to the
    JAX package: XLA and torch sum in other orders, and the Newton updates
    grow that rounding (3D lambda reads 9.5e-11 apart, 2D 1.8e-12)."""
    c, sh, _ = run
    g = _jax(c, golden)
    got = sh["admm"]
    assert (got["admm_it"], got["total_newton"], got["total_lin_iters"]) == (
        int(g["admm_admm_it"]), int(g["admm_total_newton"]), int(g["admm_total_lin_iters"]))
    assert got["solver_iters"] == g["admm_solver_iters"].tolist()
    assert (got["converged"], got["failed"]) == (bool(g["admm_converged"]), bool(g["admm_failed"]))
    for name in ("u", "lam", "Lambda"):
        assert _rel(got[name], g[f"admm_{name}"]) <= 1e-9, name
    for name in ("u_diff_norm", "lam_inc_norm", "max_grad_norm"):
        assert abs(got[name] - float(g[name])) <= 1e-9 * abs(float(g[name])), name
