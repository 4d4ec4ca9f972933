"""The patch side of the ADMM fixture of tests/test_patch_admm.py:31-87,
built once with the JAX package and once with the port from the same
mesh: 2D channel refs=2 and 3D channel refs=1, the deformation operator
with c_grad = tau = 2 as a full slot-major stencil, Chebyshev V(3,3), a
synthetic inward shape gradient on the obstacle surface, and the
undeformed volume and barycenter as constraint targets.  Float64.

Imported by the port's ADMM tests and by tests/goldens/make_admm_goldens.py."""
import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy
from admm_optim_tpu.core.mesh import refine as jrefine
from admm_optim_tpu.core.patches import build_patchset as jbuild_patchset
from admm_optim_tpu.ops import deformation as jdfm
from admm_optim_tpu.ops import patchstencil as jst
from admm_optim_tpu.ops import sparsity as jsp
from admm_optim_tpu.ops.geometry import elem_geometry
from admm_optim_tpu.optim import admm as jadmm
from admm_optim_tpu.optim.spaces import PatchOps as JPatchOps
from admm_optim_tpu.solvers import patch_mg as jmg
from admm_optim_tpu_torch import admm_run
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset
from admm_optim_tpu_torch.ops import deformation as tdfm
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import sparsity as tsp
from admm_optim_tpu_torch.optim.spaces import PatchOps
from admm_optim_tpu_torch.solvers import patch_mg

DIRICHLET = ("inlet", "wall", "outlet")
# the fixture's ADMMConfig (bicgstab x-solves)
FIXTURE_CFG = dict(admm_steps=6, ns_max_its=6, lin_max_iters=60, tau=2.0, admm_tolerance=1e-2)
# bench.py admm_throughput's loop and solver settings, on the fixture's operator
BENCH_SOLVER = dict(
    admm_steps=5, admm_tolerance=0.0, ns_max_its=2, ns_tol=1e-4, lin_max_iters=40,
    lin_abs_tol=1e-7, lin_rel_tol=1e-5, x_solver="cg",
)
SIGMA, SCALING = 0.3, 1.0
# the two ADMM runs held against the JAX package, as overrides of
# FIXTURE_CFG.  admm_steps=2 ends the BiCGStab run after four iterations,
# one fake-convergence restart among them.  Over the full fixture run (15
# iterations, 53 Newton, ~1070 Krylov iterations) the per-lane Krylov
# counts move by a few iterations with a one-ulp change of the operator,
# in the JAX package as in the port (ROADMAP.md section 3)
#
# "relaxed" runs the over-relaxed z-step (relax_alpha = 1.5) and the loose
# Krylov acceptance that f32_presets turns on (lin_accept_rel = 1e-4), with
# CG given no tolerance (a strict solve never converges) and cut at 10
# iterations, where every solve of the run is below 1e-4 of |b|.  Accepted,
# the run goes on for two ADMM iterations of 13 Newton iterates, every
# solve 10 iterations long (so no count hangs on a rounding at a tolerance);
# STRICT, the same run without the acceptance, fails at its first solve
RELAXED = dict(x_solver="cg", lin_max_iters=10, lin_abs_tol=0.0, lin_rel_tol=0.0, admm_steps=2,
               relax_alpha=1.5, lin_accept_rel=1e-4)
STRICT = dict(RELAXED, lin_accept_rel=0.0)
RUNS = {"bicgstab": dict(admm_steps=2), "cg": BENCH_SOLVER, "relaxed": RELAXED}
# the golden file of each run (tests/goldens/, made by make_admm_goldens.py);
# the relaxed file also holds STRICT's counts as "strict_*"
GOLDEN_FILES = {"admm_3d_refs1.npz": ("bicgstab", "cg"), "admm_3d_refs1_relaxed.npz": ("relaxed",)}


def _levels(gen, ref, dim, refs):
    lvl0 = gen.channel_2d(n_side=(3, 1), diag="fixed") if dim == 2 else gen.channel_3d(n_side=(2, 1, 1))
    levels = [lvl0]
    for _ in range(refs):
        levels.append(ref(levels[-1]))
    return levels


def _jp_global(fine, X):
    """The fixture's inward shape gradient (d, V), numpy float64."""
    obs = fine.subset_vertices["obstacle_surface"].astype(np.float64)
    Jp = -X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 0.3) * obs[:, None] * 0.05
    return Jp.T * (~fine.vertex_mask(DIRICHLET))[None]


def jax_targets(fine):
    """The constraint targets (volume, unnormalized barycenter) as the JAX
    package computes them.  The barycenter of the symmetric channel is
    ~1e-13, a sum with cancellation, so other summation orders (numpy's in
    admm_run.reference_targets) differ from it by ~1e-12, and the
    constraint defects g with them: enough to move loosely solved ADMM
    iterates by ~1e-9 relative."""
    coords = jnp.asarray(fine.coords)
    elems = jnp.asarray(fine.elems)
    _, _, _, vol = elem_geometry(coords, elems)
    return jnp.sum(vol), jdfm.barycenter(coords, elems, jnp.zeros_like(coords.T))


def jax_problem(dim, refs):
    hier = JHierarchy(_levels(jgeomgen, jrefine, dim, refs))
    ps = jbuild_patchset(hier)
    fine, lvl0 = hier.fine, hier.levels[0]
    coords = jnp.asarray(fine.coords)
    cfg = jadmm.ADMMConfig(**FIXTURE_CFG)
    pat0 = jsp.build_pattern(lvl0.elems, lvl0.num_vertices, dim)
    fixed0 = np.repeat(lvl0.vertex_mask(DIRICHLET)[None], dim, axis=0)

    def base_dense_fn(coords0):
        em0 = jdfm.deformation_elem_mats(coords0, jnp.asarray(lvl0.elems), cfg.c_eps, cfg.tau, cfg.c_mass)
        v0 = jsp.bake_dirichlet(pat0, jsp.assemble_values(pat0, em0), jnp.asarray(fixed0))
        return jnp.linalg.inv(jsp.to_dense(pat0, v0))

    struct = jmg.PatchMGStructure(ps)
    # jitted as bench.py does: half the time of the op-by-op assembly
    data = jax.jit(lambda c, tabs: jmg.assemble_patch_mg(
        ps, struct, c,
        lambda x: jdfm.deformation_corner_mats(x, cfg.c_eps, cfg.tau, cfg.c_mass),
        base_dense_fn, tabs=tabs,
    ))(coords, jmg.make_level_tables(ps, coords.dtype))
    ref_vol, ref_bary = jax_targets(fine)
    return types.SimpleNamespace(
        hier=hier, ps=ps, cfg=cfg, struct=struct, data=data,
        ops=JPatchOps(struct, data, jst.to_patch(ps.fine, coords.T)),
        Jp=jst.to_patch(ps.fine, jnp.asarray(_jp_global(fine, fine.coords))),
        ref_vol=ref_vol, ref_bary=ref_bary,
    )


def port_problem(dim, refs):
    hier = Hierarchy(_levels(geomgen, refine, dim, refs))
    ps = build_patchset(hier)
    fine, lvl0 = hier.fine, hier.levels[0]
    dt = torch.float64
    coords = torch.as_tensor(fine.coords, dtype=dt)
    c_eps, tau, c_mass = 1.0, FIXTURE_CFG["tau"], 1.0
    pat0 = tsp.build_pattern(lvl0.elems, lvl0.num_vertices, dim)
    fixed0 = torch.as_tensor(np.repeat(lvl0.vertex_mask(DIRICHLET)[None], dim, axis=0))
    elems0 = torch.as_tensor(lvl0.elems.astype(np.int64))

    def base_dense_fn(coords0):
        em0 = tdfm.deformation_elem_mats(coords0, elems0, c_eps, tau, c_mass)
        v0 = tsp.bake_dirichlet(pat0, tsp.assemble_values(pat0, em0), fixed0)
        return torch.linalg.inv(tsp.to_dense(pat0, v0))

    struct = patch_mg.PatchMGStructure(ps)
    data = patch_mg.assemble_patch_mg(
        ps, struct, coords, lambda x: tdfm.deformation_corner_mats(x, c_eps, tau, c_mass),
        base_dense_fn,
    )
    ref_vol, ref_bary = admm_run.reference_targets(hier)
    return types.SimpleNamespace(
        hier=hier, ps=ps, struct=struct, data=data,
        ops=PatchOps(struct, data, st.to_patch(ps.fine, coords.T)),
        Jp=st.to_patch(ps.fine, torch.as_tensor(_jp_global(fine, fine.coords))),
        ref_vol=torch.as_tensor(ref_vol), ref_bary=torch.as_tensor(ref_bary),
    )
