"""Entry points of the PyTorch port for a compile check and a
multi-process dry run (the torch twin of __graft_entry__.py, which stays
the JAX package's).

entry(device)              -> (fn, example_args): one ADMM step (z-prox,
                              constrained Newton x-update, dual ascent) on
                              the flagship 2D obstacle model, global backend.
dryrun_multichip(n, device) -> one sharded ADMM inner solve on n ranks of a
                              (batch, space) grid (the reference's MPI domain
                              decomposition, 2d_admm.lua:147-209, with a
                              design sweep over batch), then dryrun_3d_deep.
dryrun_3d_deep(n, device)  -> 3D refs=2 on n ranks of one space axis, levels
                              below 1 agglomerated: an IR solve to 1e-8 and a
                              two-iteration ADMM inner solve.

The ranks are processes of a gloo group (parallel.launch) on the CPU or,
all of them, on the one card; device None means the card and raises
without one.  float64 on the CPU, float32 on the card.

    python3 graft_entry_torch.py [n] [cpu]
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any

import numpy as np
import torch

from admm_optim_tpu_torch import resolve_device
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, MeshLevel, refine
from admm_optim_tpu_torch.core.patches import PatchSet, build_patchset
from admm_optim_tpu_torch.ops import deformation as dfm
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.ops.geometry import elem_geometry
from admm_optim_tpu_torch.ops.p1space import P1VectorSpace
from admm_optim_tpu_torch.optim import admm
from admm_optim_tpu_torch.optim.spaces import GlobalOps
from admm_optim_tpu_torch.parallel import launch
from admm_optim_tpu_torch.parallel.patch_shard import build_sharded_mg
from admm_optim_tpu_torch.parallel.sharding import make_mesh
from admm_optim_tpu_torch.xupdate_solve import DIRICHLET

# seconds the ranks of one dry run may take, and each of their collectives
TIMEOUT_S = 900.0
# the 2D phase's ADMM, and the deep phase's: tolerances a few Newton
# iterations reach on the dry run's synthetic shape gradient (the outer
# ADMM tolerance is not expected within two iterations)
ADMM_2D = admm.ADMMConfig(admm_steps=2, ns_max_its=2, lin_max_iters=25, tau=2.0)
ADMM_DEEP = admm.ADMMConfig(admm_steps=2, ns_max_its=4, lin_max_iters=200, ns_tol=5e-3, lin_abs_tol=1e-9,
                            lin_rel_tol=1e-7)
DEEP_IR = dict(rel_tol=1e-8, max_rounds=6, inner_rel=1e-5, inner_iters=60)
DEEP_SIGMA = 0.3


def _dtype(device) -> torch.dtype:
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def _channel(dim: int, num_refs: int, diag: str = "fixed") -> Hierarchy:
    levels = [geomgen.channel_2d(diag=diag) if dim == 2 else geomgen.channel_3d()]
    for _ in range(num_refs):
        levels.append(refine(levels[-1]))
    return Hierarchy(levels)


def shape_gradient(fine: MeshLevel, scale: float) -> np.ndarray:
    """The dry run's synthetic J' (C, V): the obstacle surface pushed
    toward the origin, zero on Dirichlet vertices (__graft_entry__.py)."""
    X = fine.coords
    obs = fine.subset_vertices["obstacle_surface"].astype(X.dtype)
    Jp = (-X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 0.3) * obs[:, None] * scale).T
    return Jp * (~fine.vertex_mask(DIRICHLET))[None]


def reference_targets(fine: MeshLevel):
    """Volume and unnormalized barycenter of the undeformed mesh, float64."""
    X = torch.as_tensor(fine.coords, dtype=torch.float64)
    E = torch.as_tensor(fine.elems.astype(np.int64))
    return float(elem_geometry(X, E)[3].sum()), dfm.barycenter(X, E, torch.zeros_like(X.T)).numpy()


def entry(device=None):
    """(fn, example_args): fn(u, lam, Jp, sigma) -> (u, lam, |lam increment|),
    one ADMM step on the 2D refs=1 channel with the global backend."""
    dev = resolve_device(device)
    dtype = _dtype(dev)
    hier = _channel(2, 1, diag="alt")
    fine = hier.fine
    cfg = ADMM_2D
    space = P1VectorSpace.build(hier)
    struct = space.mg_structure()
    coords = torch.as_tensor(fine.coords, dtype=dtype, device=dev)
    elems = torch.as_tensor(fine.elems.astype(np.int64), device=dev)
    mgdata = space.assemble_mg(struct, coords, cfg.c_eps, cfg.tau, cfg.c_mass)
    ops_ = GlobalOps(struct, mgdata, coords, elems, space.free_mask(dtype=dtype, device=dev))
    ref_vol = elem_geometry(coords, elems)[3].sum()
    ref_bary = dfm.barycenter(coords, elems, torch.zeros_like(coords.T))
    Jp = torch.as_tensor(shape_gradient(fine, 0.1), dtype=dtype, device=dev)

    def step(u, lam, Jp, sigma):
        q = dfm.z_update(coords, elems, u, lam, cfg.tau, sigma, cfg.norm_name)
        nr = admm.newton_xupdate_ops(cfg, ops_, Jp, 1.0, lam, q, ref_vol, ref_bary, u,
                                     u.new_zeros(1 + coords.shape[1]))
        lam_new, inc = dfm.dual_update(coords, elems, nr.u, lam, q, cfg.tau)
        return nr.u, lam_new, admm.l2_norm_pc(coords, elems, inc)

    d = coords.shape[1]
    u0 = torch.zeros_like(coords.T)
    lam0 = coords.new_zeros((d, d, elems.shape[0]))
    return step, (u0, lam0, Jp, torch.tensor(0.3, dtype=dtype, device=dev))


@dataclasses.dataclass
class ShardProblem:
    """What the ranks of a dry run are handed, host arrays only: the
    unpadded patch set, the coarse mesh of the base solve and the global
    vectors each rank lays out and shards itself."""

    ps: PatchSet
    lvl0: MeshLevel
    coords: np.ndarray  # (V, d)
    Jp: np.ndarray  # (C, V)
    ref_vol: float
    ref_bary: np.ndarray  # (d,)
    b: np.ndarray | None = None  # (C, V) right-hand side of the IR solve
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


def problem_2d() -> ShardProblem:
    """The 2D phase: the refs=1 channel with fixed diagonals (bricks)."""
    hier = _channel(2, 1)
    fine = hier.fine
    return ShardProblem(build_patchset(hier), hier.levels[0], fine.coords, shape_gradient(fine, 0.05),
                        *reference_targets(fine))


def problem_deep() -> ShardProblem:
    """The deep phase: the 3D refs=2 channel, the IR solve's right-hand
    side from default_rng(7)."""
    hier = _channel(3, 2)
    fine = hier.fine
    b = np.random.default_rng(7).normal(size=(3, fine.num_vertices)) * (~fine.vertex_mask(DIRICHLET))[None]
    return ShardProblem(build_patchset(hier), hier.levels[0], fine.coords, shape_gradient(fine, 0.05),
                        *reference_targets(fine), b=b,
                        meta=dict(V=fine.num_vertices, E=fine.num_elems, levels=len(hier.levels)))


def _assembled(p: ShardProblem, mesh, replicate_below: int, cfg: admm.ADMMConfig):
    dtype = _dtype(mesh.device)
    sh = build_sharded_mg(p.ps, mesh, replicate_below=replicate_below, data_dtype=dtype)
    coords_p = sh.to_patch_sharded(p.coords.T, dtype)
    return sh, coords_p, sh.assemble(coords_p, p.lvl0, cfg)


def admm_summary(sh, st: admm.ADMMState) -> dict:
    """An ADMM state's counters and flags, and its u and dual tensor
    gathered whole (numpy)."""
    return dict(
        admm_it=st.admm_it, total_newton=st.total_newton, total_lin_iters=st.total_lin_iters,
        solver_iters=list(st.solver_iters), converged=st.converged, failed=st.failed,
        u_diff_norm=st.u_diff_norm, lam_inc_norm=st.lam_inc_norm, max_grad_norm=st.max_grad_norm,
        Lambda=st.Lambda.double().cpu().numpy(), u=sh.gather_field(st.u).double().cpu().numpy(),
        lam=sh.gather_field(st.lam).double().cpu().numpy(),
    )


def batch_space_rank(rank, world, device, p: ShardProblem):
    """The 2D phase on one rank: a (2, world / 2) grid (world even, else
    (1, world)), B = 2 * n_batch instances with sigmas from 0.25 to 0.4
    over batch, each an ADMM inner solve sharded over space."""
    n_batch = 2 if world % 2 == 0 and world > 1 else 1
    mesh = make_mesh(world // n_batch, n_batch, device)
    sh, coords_p, data = _assembled(p, mesh, 0, ADMM_2D)
    B = max(2 * n_batch, 2)
    Jp = sh.to_patch_sharded(p.Jp, coords_p.dtype)
    dev, dt = coords_p.device, coords_p.dtype
    states = sh.admm_inner_batched(
        ADMM_2D, data, coords_p, sh.pvalid(), Jp.expand((B,) + Jp.shape), np.linspace(0.25, 0.4, B), 1.0,
        torch.tensor(p.ref_vol, dtype=dt, device=dev), torch.as_tensor(p.ref_bary, dtype=dt, device=dev),
    )
    return dict(batch=mesh.batch_index, space=mesh.space_index, P=sh.ps.P, P_orig=sh.P_orig,
                states=[admm_summary(sh, s) for s in states])


def deep_rank(rank, world, device, p: ShardProblem, admm_only: bool = False):
    """The deep phase on one rank: the IR solve (skipped with admm_only)
    and the ADMM inner solve, on world ranks of one space axis with level
    0 agglomerated; the kernel launches of each, counted from 0 on this
    rank."""
    mesh = make_mesh(world, 1, device)
    sh, coords_p, data = _assembled(p, mesh, 1, ADMM_DEEP)
    dev, dt = coords_p.device, coords_p.dtype
    out = dict(P=sh.ps.P, P_orig=sh.P_orig, P_local=coords_p.shape[-1])
    if not admm_only:
        sk.reset_launches()
        res = sh.solve_ir(data, sh.to_patch_sharded(p.b, dt), **DEEP_IR)
        out["ir"] = dict(rounds=res.rounds, inner_iters=res.inner_iters, res_norm=float(res.res_norm),
                         converged=res.converged,
                         x=sh.gather_field(res.x_hi.double() + res.x_lo.double()).cpu().numpy(),
                         launches=dict(sk.launches_by_lattice))
    sk.reset_launches()
    st = sh.admm_inner(ADMM_DEEP, data, coords_p, sh.pvalid(), sh.to_patch_sharded(p.Jp, dt), DEEP_SIGMA, 1.0,
                       torch.tensor(p.ref_vol, dtype=dt, device=dev), torch.as_tensor(p.ref_bary, dtype=dt, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["admm"] = dict(admm_summary(sh, st), launches=dict(sk.launches_by_lattice))
    out["sent_bytes"] = sh.spmd.sent_bytes
    return out


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The 2D batch x space phase on n_devices ranks, then the deep phase."""
    dev = resolve_device(device)
    outs = launch.spawn(batch_space_rank, n_devices, "gloo", dev, TIMEOUT_S, problem_2d())
    grid = {(o["batch"], o["space"]) for o in outs}
    n_batch = 1 + max(b for b, _ in grid)
    _check(len(grid) == n_devices, f"every rank has its own grid place: {sorted(grid)}")
    states = [s for o in outs if o["space"] == 0 for s in o["states"]]
    for s in states:
        _check(np.isfinite(s["u"]).all() and np.isfinite(s["lam"]).all(), "finite u and lambda")
    _check(sum(s["total_newton"] for s in states) > 0, "Newton iterations ran")
    print(f"dryrun_multichip OK: grid batch={n_batch} space={n_devices // n_batch} B={len(states)} "
          f"P={outs[0]['P']} (orig {outs[0]['P_orig']}) newton={[s['total_newton'] for s in states]} "
          f"lam_inc={[f'{s['lam_inc_norm']:.2e}' for s in states]} on {dev}")
    dryrun_3d_deep(n_devices, dev)


def dryrun_3d_deep(n_devices: int, device=None) -> None:
    """The deep phase alone: its IR solve must converge, its ADMM run
    Newton iterations and leave no Krylov or Newton solve failed before
    its two iterations (st.failed alone also means the outer tolerance was
    not met, which two iterations are not expected to meet)."""
    dev = resolve_device(device)
    p = problem_deep()
    out = launch.spawn(deep_rank, n_devices, "gloo", dev, TIMEOUT_S, p)[0]
    ir, st = out["ir"], out["admm"]
    _check(ir["converged"], f"the 3D IR solve converged: rel residual {ir['res_norm']:.3e}")
    print(f"dryrun_multichip 3D-deep OK: space={n_devices} 3D refs=2 V={p.meta['V']} E={p.meta['E']} "
          f"levels={p.meta['levels']} agglomerated(levels<1 replicated) P={out['P']} (orig {out['P_orig']}) "
          f"IR rel_residual={ir['res_norm']:.3e} rounds={ir['rounds']} inner_iters={ir['inner_iters']}")
    _check(np.isfinite(st["u"]).all(), "finite u")
    _check(st["total_newton"] > 0, "Newton iterations ran")
    _check(not (st["failed"] and st["admm_it"] < ADMM_DEEP.admm_steps), f"no solver failed (admm_it {st['admm_it']})")
    print(f"dryrun_multichip 3D-deep ADMM OK: admm_it={st['admm_it']} newton={st['total_newton']} "
          f"lin_iters={st['total_lin_iters']} lam_inc={st['lam_inc_norm']:.3e} u_diff={st['u_diff_norm']:.3e}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2, sys.argv[2] if len(sys.argv) > 2 else None)
