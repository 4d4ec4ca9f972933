"""State carried across from the JAX package.

Turns the JAX package's assembled multigrid state, given as numpy arrays
(e.g. ``jax.tree_util.tree_map(np.asarray, data)`` of an
``admm_optim_tpu.solvers.patch_mg.PatchMGData``), into the port's
PatchMGData and LevelTables on a torch device.  Only attributes are read,
so this module imports nothing of JAX.
"""
from __future__ import annotations

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

    return st.LevelTables(
        owner=tensor(tab.owner, device),
        free=tensor(tab.free, device),
        gid=idx(tab.gid),
        bslots=idx(lvl.bslots),
        bseg=idx(lvl.bseg),
        nseg=int(lvl.nseg),
        dfg_bidx=tuple(idx(b) for b in (tab.dfg_bidx or ())),
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
