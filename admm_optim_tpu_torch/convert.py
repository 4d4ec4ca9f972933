"""State carried across from the JAX package.

Turns the JAX package's state, given as numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, data)``), into the port's on a torch
device: the assembled multigrid state (``PatchMGData`` and its
``LevelTables``), the ADMM configuration and state, the Newton
configuration, the packed NS state, the PCD Schur data, the problem
configuration of the optimization step and its resume state.  Only
attributes are read, so this module imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.patches import PatchLevel, PatchSet
from .ops import patchstencil as st
from .solvers import patch_mg


def tensor(a, device, dtype=None) -> torch.Tensor:
    """numpy (or array-like) -> tensor; bfloat16 arrays (ml_dtypes, which
    numpy cannot hand to torch directly) go through their bit pattern."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def level_tables(tab, lvl: PatchLevel, device) -> st.LevelTables:
    """JAX LevelTables -> port LevelTables.  The ownership, Dirichlet,
    global-id and DF group tables come from ``tab``; the segment-sum
    exchange tables come from the host level ``lvl``, because the JAX
    tables of slab-exchange levels do not carry them."""
    def idx(a):
        return tensor(np.asarray(a).astype(np.int64), device)

    dfg_bidx = tuple(idx(b) for b in (tab.dfg_bidx or ()))
    return st.LevelTables(
        owner=tensor(tab.owner, device),
        free=tensor(tab.free, device),
        gid=idx(tab.gid),
        bslots=idx(lvl.bslots),
        bseg=idx(lvl.bseg),
        nseg=int(lvl.nseg),
        dfg_bidx=dfg_bidx,
        kmax=max((b.shape[1] for b in dfg_bidx), default=0),
    )


def patch_mg_data(data, ps: PatchSet, device) -> patch_mg.PatchMGData:
    """JAX PatchMGData (numpy leaves) -> port PatchMGData.  Pencil-major
    smoother stencils (JAX PencilW, an object with an ``a`` array) become
    port PencilW tags."""
    W_sm = None
    if data.W_sm is not None:
        W_sm = [
            None if w is None else st.PencilW(tensor(w.a, device)) for w in data.W_sm
        ]
    return patch_mg.PatchMGData(
        W=[tensor(w, device) for w in data.W],
        inv_diag=[tensor(v, device) for v in data.inv_diag],
        lmax=[tensor(v, device) for v in data.lmax],
        base_inv=tensor(data.base_inv, device),
        tabs=[level_tables(t, lvl, device) for t, lvl in zip(data.tabs, ps.levels)],
        W_sm=W_sm,
    )


def pcd_data(ap_data, W_fp, mp, ps: PatchSet, device):
    """The JAX package's PCD Schur data (ns_pcd_precond_data_patch, numpy
    leaves) -> the port's (ap_data, W_fp, mp): the scalar pressure-Laplacian
    hierarchy with its per-level W, inverse diagonals, lmax, dense base
    inverse and level tables (whose ``free`` masks are the PCD
    inlet-Dirichlet ones), the pressure convection-diffusion stencil and the
    lumped pressure mass."""
    return patch_mg_data(ap_data, ps, device), tensor(W_fp, device), tensor(mp, device)


def admm_config(cfg):
    """JAX ADMMConfig -> port ADMMConfig (xsolve_sequential is not ported)."""
    from .optim.admm import ADMMConfig

    return ADMMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(ADMMConfig)})


def newton_config(cfg):
    """JAX NewtonConfig -> port NewtonConfig (every field by name)."""
    from .solvers.ns_solver import NewtonConfig

    return NewtonConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(NewtonConfig)})


def problem_config(cfg):
    """JAX ProblemConfig -> port ProblemConfig, field by field, with its
    ADMM and Newton configurations through admm_config and newton_config."""
    from .models.obstacle import ProblemConfig

    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ProblemConfig)}
    out.update(admm=admm_config(cfg.admm), ns=newton_config(cfg.ns))
    return ProblemConfig(**out)


def resume_state(d, device, dtype=None) -> dict:
    """A JAX checkpoint dict (io.checkpoint.load_checkpoint: numpy arrays)
    -> the port's ObstacleShapeOpt.run(resume=...): X (V, d) and the packed
    state s as tensors on the device, sigma, drag_old and drag_init as
    floats, step as an int (drag_init defaults to drag_old), and the
    accepted history and failure catalogue (history_json, failures_json)
    as the strings they are.  run(resume=) also takes the dict as it
    comes."""
    out = dict(
        X=tensor(d["X"], device, dtype).contiguous(), s=ns_state(d["s"], device, dtype),
        sigma=float(d["sigma"]), step=int(d["step"]), drag_old=float(d["drag_old"]),
    )
    out["drag_init"] = float(d["drag_init"]) if "drag_init" in d else out["drag_old"]
    for key in ("history_json", "failures_json"):
        if key in d:
            out[key] = str(d[key])
    return out


def ns_state(s, device, dtype=None) -> torch.Tensor:
    """A packed NS state [v (dim, n_vel) component-major, p (V)] from the
    JAX package (or numpy) -> a flat tensor on the device; the packing is
    the same in both packages."""
    return tensor(np.asarray(s).reshape(-1), device, dtype)


def admm_state(state, device):
    """JAX ADMMState with numpy leaves -> port ADMMState: fields on the
    device, counters, flags and norms as Python scalars, stats as float64
    on the host."""
    from .optim.admm import ADMMState

    return ADMMState(
        u=tensor(state.u, device), u_old=tensor(state.u_old, device),
        lam=tensor(state.lam, device), q_proj=tensor(state.q_proj, device),
        Lambda=tensor(state.Lambda, device),
        scaling=float(state.scaling), admm_it=int(state.admm_it),
        total_newton=int(state.total_newton), total_lin_iters=int(state.total_lin_iters),
        solver_iters=[int(v) for v in np.asarray(state.solver_iters)],
        converged=bool(state.converged), failed=bool(state.failed),
        u_diff_norm=float(state.u_diff_norm), lam_inc_norm=float(state.lam_inc_norm),
        max_grad_norm=float(state.max_grad_norm),
        stats=tensor(state.stats, "cpu", torch.float64),
    )
