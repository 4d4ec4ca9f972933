"""What the sharded-port tests run on each rank (tests/test_torch_patch_shard.py,
tests/test_torch_sharding.py): module-level functions, so that
parallel.launch.spawn can hand them to fresh processes, importing torch
and the port only."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset, pad_patchset
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.optim import admm
from admm_optim_tpu_torch.parallel.patch_shard import build_sharded_mg
from admm_optim_tpu_torch.parallel.sharding import make_mesh, shard_elements
from admm_optim_tpu_torch.xupdate_solve import DIRICHLET

import graft_entry_torch as ge

# the sharded ADMM's configuration (tests/test_patch_shard.py's), and the
# solves': CG to 1e-10 in at most 40 iterations, the IR solve to 1e-10
ADMM_CFG = admm.ADMMConfig(admm_steps=2, ns_max_its=3, ns_tol=5e-3, lin_max_iters=60, tau=2.0, admm_tolerance=1e-2)
CG = dict(max_iters=40, rel_tol=1e-10)
IR = dict(rel_tol=1e-10, max_rounds=4, inner_rel=1e-5, inner_iters=40)
SIGMA = 0.3
# the fixtures: dim, refs, ranks (P 34 -> 36 in 2D, 44 in 3D)
CASES = {"2d": (2, 2, 4), "3d": (3, 1, 2)}


@dataclasses.dataclass
class Case:
    """A fixture's host data: the unpadded patch set, the mesh's coarse
    level and fine coordinates, and seeded inputs laid out on the padded
    set of `ranks` shards."""

    ranks: int
    hier: Hierarchy
    ps: object  # unpadded PatchSet
    ps_pad: object
    x_add: list  # per level a (C, *lat, P_pad) additive field
    xh: np.ndarray  # float32 hi part of an additive fine field
    xl: np.ndarray
    b: np.ndarray  # (C, V) right-hand side, zero on Dirichlet vertices
    Jp: np.ndarray  # (C, V) the dry run's synthetic J'
    ref_vol: float
    ref_bary: np.ndarray


def case(dim: int, refs: int, ranks: int, seed: int = 0) -> Case:
    """2D: channel_2d(n_side=(3, 2), diag="fixed"), P = 34; 3D:
    channel_3d(n_side=(2, 1, 1)), P = 44 (tests/test_patch_shard.py's)."""
    levels = [geomgen.channel_2d(n_side=(3, 2), diag="fixed") if dim == 2 else geomgen.channel_3d(n_side=(2, 1, 1))]
    for _ in range(refs):
        levels.append(refine(levels[-1]))
    hier = Hierarchy(levels)
    ps = build_patchset(hier)
    ps_pad = pad_patchset(ps, ranks)
    rng = np.random.default_rng(seed)
    x_add = [rng.normal(size=(dim,) + lvl.lat_shape + (lvl.P,)) for lvl in ps_pad.levels]
    x64 = rng.normal(size=x_add[-1].shape)
    xh = x64.astype(np.float32)
    xl = (x64 - xh).astype(np.float32)
    fine = hier.fine
    b = rng.normal(size=(dim, fine.num_vertices)) * (~fine.vertex_mask(DIRICHLET))[None]
    return Case(ranks, hier, ps, ps_pad, x_add, xh, xl, b, ge.shape_gradient(fine, 0.05),
                *ge.reference_targets(fine))


def _numpy(t):
    return t.detach().cpu().numpy()


def shard_rank(rank, world, device, c: Case):
    """Every sharded piece on one rank of a world-rank space axis, float64:
    each level's exchange (and on the fine level its fixed-order GPU form
    and the double-float exchange), owner_dot, from_patch_tab, the
    assembly, the MG and IR solves, the same with level 0 agglomerated,
    and the ADMM inner loop; fields gathered whole (rank 0's return)."""
    mesh = make_mesh(world, 1, device)
    sh = build_sharded_mg(c.ps, mesh, data_dtype=torch.float64)
    spmd, ps = sh.spmd, sh.ps
    tabs = sh.make_tables()
    out = {"P_local": ps.P // world}
    out["exchange"] = [_numpy(sh.gather_field(st.exchange_sum(None, sh.shard_field(x), tab, spmd=spmd)))
                       for x, tab in zip(c.x_add, tabs)]
    fine_tab = tabs[-1]
    x = sh.shard_field(c.x_add[-1])
    n = fine_tab.owner.numel()
    groups = st.exchange_groups(fine_tab, st._with_remote(fine_tab, x.reshape(-1, n), spmd))[:, :n]
    out["exchange_groups"] = _numpy(sh.gather_field(groups.reshape(x.shape)))
    yh, yl = st.exchange_sum_df(fine_tab, sh.shard_field(c.xh), sh.shard_field(c.xl), spmd=spmd)
    out["df"] = (_numpy(sh.gather_field(yh)), _numpy(sh.gather_field(yl)))
    y = sh.shard_field(c.x_add[-1][::-1].copy())
    out["owner_dot"] = float(st.owner_dot(None, x, y, fine_tab, spmd=spmd))
    out["owner_dot_lanes"] = _numpy(st.owner_dot(None, torch.stack([x, y]), torch.stack([y, y]), fine_tab, spmd=spmd))
    V = c.hier.fine.num_vertices
    out["from_patch_tab"] = _numpy(st.from_patch_tab(fine_tab, x, V, spmd=spmd))
    unpadded = c.x_add[-1][..., : c.ps.P]
    out["pad_field"] = _numpy(sh.gather_field(sh.pad_field(unpadded)))
    coords_p = sh.to_patch_sharded(c.hier.fine.coords.T, torch.float64)
    b = sh.to_patch_sharded(c.b, torch.float64)
    for rb in (0, 1):
        shr = sh if rb == 0 else build_sharded_mg(c.ps, mesh, replicate_below=rb, data_dtype=torch.float64)
        data = shr.assemble(coords_p, c.hier.levels[0], ADMM_CFG)
        sharded = [l >= rb for l in range(len(ps.levels))]
        out[f"W{rb}"] = [_numpy(sh.gather_field(W) if s else W) for W, s in zip(data.W, sharded)]
        out[f"inv_diag{rb}"] = [_numpy(sh.gather_field(d) if s else d) for d, s in zip(data.inv_diag, sharded)]
        out[f"lmax{rb}"] = [float(v) for v in data.lmax]
        out[f"base_inv{rb}"] = _numpy(data.base_inv)
        out[f"vcycle{rb}"] = _numpy(sh.gather_field(shr.vcycle(data, b)))
        res = shr.solve(data, b, **CG)
        out[f"cg{rb}"] = dict(iters=int(res.iters), converged=bool(res.converged), x=_numpy(sh.gather_field(res.x)))
        ir = shr.solve_ir(data, b, **IR)
        out[f"ir{rb}"] = dict(rounds=ir.rounds, inner_iters=ir.inner_iters, converged=ir.converged,
                              x=_numpy(sh.gather_field(ir.x_hi + ir.x_lo)))
        if rb == 0:
            st_ = sh.admm_inner(ADMM_CFG, data, coords_p, sh.pvalid(), sh.to_patch_sharded(c.Jp, torch.float64),
                                SIGMA, 1.0, torch.tensor(c.ref_vol, dtype=torch.float64),
                                torch.as_tensor(c.ref_bary))
            out["admm"] = ge.admm_summary(sh, st_)
    out["sent_bytes"] = spmd.sent_bytes
    return out if rank == 0 else None


def grid_rank(rank, world, device, n_space, n_batch, elems):
    """make_mesh on an (n_batch, n_space) grid: this rank's place, the sum
    of the world ranks over its space group, and its shard_elements
    block."""
    mesh = make_mesh(n_space, n_batch, device)
    t = torch.tensor([float(rank)])
    dist.all_reduce(t, group=mesh.space_group)
    return dict(batch=mesh.batch_index, space=mesh.space_index, space_sum=float(t),
                block=shard_elements(mesh, elems).numpy())


def raising_rank(rank, world, device):
    """Rank 1 raises at once; rank 0 waits in a collective for it."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return rank


def hanging_rank(rank, world, device):
    """Rank 1 never reaches the collective rank 0 waits in."""
    if rank == 1:
        time.sleep(120.0)
    dist.all_reduce(torch.zeros(1))
    return rank
