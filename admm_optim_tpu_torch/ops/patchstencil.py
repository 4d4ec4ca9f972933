"""Brick-patch lattice operators (port of the single-device parts of
admm_optim_tpu/ops/patchstencil.py that the deformation MG solve uses).

Fields are dense patch arrays ``(C, *lat, P)`` (lattice dims major, patch
axis minor).  The operator is a per-site stencil stored SLOT-MAJOR,

    W (O, C, C, *lat, P):   y[c, s] = sum_o sum_d W[o, c, d, s] * x[d, s+o]

with O = 7 (2D) / 15 (3D) lattice offsets, or as its symmetric half
(H = 4 / 8 slots, ``half_slots``), or tagged pencil-major (``PencilW``).

Duplicated-site semantics (the UG4 additive/consistent storage protocol):
patch arrays of a global vector hold identical values at sites shared
between bricks ("consistent"); operator application yields per-patch
partial sums ("additive"); ``exchange_sum`` restores consistency by summing
duplicates.

Left out on purpose: the TPU memory workarounds (``p_chunk``/``row_chunk``
assembly, the row-chunked DF apply), the roll/slab exchange fast paths,
which were tuned on the TPU, and the SPMD paths.  The stencil applies
themselves live in ops.stencil_kernels (CUDA kernels + plain twins).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.patches import PatchLevel, PatchSet
from . import df


# ---------------------------------------------------------------------------
# slicing helpers
# ---------------------------------------------------------------------------

def _dst_src(o, lat_shape):
    """Static slice pairs so that dst[s] aligns with src[s] = s + o."""
    dst, src = [], []
    for oo, n in zip(o, lat_shape):
        oo = int(oo)
        dst.append(slice(max(-oo, 0), n - max(oo, 0)))
        src.append(slice(max(oo, 0), n + min(oo, 0)))
    return tuple(dst), tuple(src)


def shift_read(x, o, lat_axes_offset=0):
    """y[s] = x[s + o] with 0 outside; lattice dims start at axis
    lat_axes_offset."""
    lat_shape = x.shape[lat_axes_offset : lat_axes_offset + len(o)]
    dst, src = _dst_src(o, lat_shape)
    pre = (slice(None),) * lat_axes_offset
    y = torch.zeros_like(x)
    y[pre + dst] = x[pre + src]
    return y


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def half_slots(ps: PatchSet) -> list:
    """Slot indices of the symmetric half-stencil: one of each {o, -o} pair
    (center first), 8 of 15 in 3D.  For a symmetric operator
    W[-o] = W[o]^T at the shifted site, so only these are stored."""
    kept = []
    for oi, o in enumerate(ps.stencil):
        nj = ps.stencil_slot[tuple(int(-v) for v in o)]
        if oi <= nj:
            kept.append(oi)
    return kept


def assemble_w(ps: PatchSet, level: int, coords_p, corner_mat_fn, sym=False, free=None):
    """Assemble the stencil operator on one level.

    coords_p: (d, *lat, P) lattice coordinates of that level.
    corner_mat_fn: corners (d, nl, *cells, P) -> (C, C, nl, nl, *cells, P)
    element matrices, or the block protocol corners -> blk with
    blk(a, b) = (C, C, *cells, P) (ops.deformation.deformation_corner_block_fn).

    Per element class the nl x nl local couplings accumulate in place into
    the stencil slot of their offset difference, over the cell box
    [o, o + m) of the site lattice.  The sum order matches the JAX form's
    zero-padded term sum, which adds zeros elsewhere.

    sym: store only the symmetric half-stencil (half_slots order); valid
    iff A[:, :, a, b] = A[:, :, b, a]^T.  free: optional (*lat, P)
    Dirichlet mask folded into every block (= bake_dirichlet_w after)."""
    dim = ps.dim
    mc = tuple(n - 1 for n in coords_p.shape[1 : 1 + dim])
    if sym:
        kpos = {s: i for i, s in enumerate(half_slots(ps))}
    else:
        kpos = {i: i for i in range(len(ps.stencil))}
    W = None
    for co in ps.class_offsets:  # (nl, dim)
        boxes = [
            tuple(slice(int(o), int(o) + mm) for o, mm in zip(cv, mc)) for cv in co
        ]
        corners = torch.stack(
            [coords_p[(slice(None),) + box] for box in boxes], dim=1
        )  # (d, nl, *m^dim, P)
        A = corner_mat_fn(corners)  # (C, C, nl, nl, *m^dim, P) or blk(a, b)
        blk = A if callable(A) else (lambda a, b, A=A: A[:, :, a, b])
        if free is not None:
            fcell = [free[box] for box in boxes]  # per corner, (*m^dim, P)
        for a in range(dim + 1):
            for b in range(dim + 1):
                slot = ps.stencil_slot[tuple(int(v) for v in (co[b] - co[a]))]
                pos = kpos.get(slot)
                if pos is None:
                    continue
                t = blk(a, b)
                if free is not None:
                    t = t * (fcell[a] * fcell[b])[None, None]
                if W is None:
                    W = t.new_zeros(
                        (len(kpos),) + t.shape[:2]
                        + tuple(m + 1 for m in mc) + t.shape[-1:]
                    )
                W[(pos, slice(None), slice(None)) + boxes[a]] += t
    return W  # (O or H, C, C, *lat, P) slot-major


def expand_sym_w(ps: PatchSet, W):
    """Symmetric half-stencil W (H, C, C, *lat, P) -> full slot-major
    (O, C, C, *lat, P): a missing slot o is the transposed shift_read of
    its kept pair -o (zero beyond the lattice edge)."""
    kept = half_slots(ps)
    if W.shape[0] == len(ps.stencil):
        return W
    pos = {k: i for i, k in enumerate(kept)}
    slots = []
    for oi, o in enumerate(ps.stencil):
        nj = ps.stencil_slot[tuple(int(-v) for v in o)]
        if oi in pos:
            slots.append(W[pos[oi]])
        else:
            t = W[pos[nj]].transpose(0, 1)  # transpose (c, d)
            slots.append(shift_read(t, o, lat_axes_offset=2))
    return torch.stack(slots, dim=0)


def bake_dirichlet_w(ps: PatchSet, level: int, W, free=None):
    """Zero Dirichlet rows and columns of W (free-subspace solves)."""
    lvl = ps.levels[level]
    if free is None:
        free = torch.as_tensor(lvl.free, dtype=W.dtype, device=W.device)  # (*lat, P)
    offs = (
        ps.stencil
        if W.shape[0] == len(ps.stencil)
        else [ps.stencil[i] for i in half_slots(ps)]
    )
    W = W * free[None, None, None]  # rows
    cols = torch.stack([shift_read(free, o) for o in offs], dim=0)  # free at s+o
    return W * cols[:, None, None]


def stencil_diag(ps: PatchSet, level: int, W):
    """Additive per-copy diagonal (C, *lat, P): W[0, c, c]."""
    ar = torch.arange(W.shape[1], device=W.device)
    return W[0][ar, ar]


@dataclasses.dataclass
class PencilW:
    """Explicit layout tag for pencil-major stencil storage
    (n0, n1, O, C, C, n2, P; stencil_kernels.to_pencil_major).  apply_w
    dispatches on this type, never on axis sizes."""

    a: torch.Tensor

    @property
    def dtype(self):
        return self.a.dtype


def apply_w(ps: PatchSet, W, x):
    """Additive operator application: x consistent (C, *lat, P) -> y
    additive (C, *lat, P).  Dispatch by storage:

    * PencilW (the bf16 smoother stream) -> stencil_kernels.apply_w_pencil;
    * symmetric half W (H slots) -> stencil_kernels.apply_w_sym;
    * full slot-major W -> the plain full-stencil form on the CPU.  On the
      GPU that is the TPU kernel K5's job, which is not ported yet
      (ROADMAP), so a CUDA tensor raises."""
    from . import stencil_kernels as sk

    if isinstance(W, PencilW):
        return sk.apply_w_pencil(ps, W.a, x)
    if W.shape[0] != len(ps.stencil):
        return sk.apply_w_sym(ps, W, x)
    if x.device.type != "cpu":
        raise NotImplementedError(
            "full slot-major W on the GPU needs the full-stencil kernel "
            "(pallas_stencil._apply_w_pallas_3d), which is not ported yet"
        )
    return sk._apply_w_full(ps, W, x)


def apply_w_df(ps: PatchSet, W, xh, xl):
    """Double-float operator application: y = A (xh + xl) as an additive
    (hi, lo) pair accurate to O(eps^2) - the once-per-refinement residual
    of solvers.patch_mg.cg_ir_p.  Symmetric half W goes to
    stencil_kernels.apply_w_df_sym; full W takes the plain EFT form."""
    from . import stencil_kernels as sk

    if W.shape[0] != len(ps.stencil):
        return sk.apply_w_df_sym(ps, W, xh, xl)
    return sk._apply_w_df_full(ps, W, xh, xl)


# ---------------------------------------------------------------------------
# consistency exchange / inner products / global glue
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LevelTables:
    """Device-side exchange/ownership tables for one patch level."""

    owner: torch.Tensor  # (*lat, P) 1.0 at owned sites
    free: torch.Tensor  # (*lat, P) 0.0 at Dirichlet sites
    gid: torch.Tensor  # (*lat, P) int64 global vertex ids
    bslots: torch.Tensor  # (B,) int64 flat duplicated slots (site-major)
    bseg: torch.Tensor  # (B,) int64 duplicate-group id per slot
    nseg: int
    # error-free exchange (exchange_sum_df): per distinct group size k a
    # dense (g_k, k) flat-slot table, groups ordered bucket-major
    dfg_bidx: tuple = ()


def _df_group_tables(lvl: PatchLevel) -> list:
    """Bucketed duplicate-group tables for exchange_sum_df: groups
    renumbered bucket-major (ascending member count), one dense (g_k, k)
    flat-slot table per distinct count k (no padding lanes; most groups
    are pairs).  Same tables, hence the same fold order, as the JAX
    package's _df_group_tables."""
    if lvl.nseg == 0:
        return []
    counts = np.bincount(lvl.bseg, minlength=lvl.nseg)
    order_g = np.argsort(counts, kind="stable")
    new_of_old = np.empty(lvl.nseg, np.int64)
    new_of_old[order_g] = np.arange(lvl.nseg)
    new_seg = new_of_old[lvl.bseg]
    order_m = np.argsort(new_seg, kind="stable")
    slots_s = lvl.bslots[order_m]
    counts_sorted = counts[order_g]
    bidx = []
    mpos = 0
    for k in np.unique(counts_sorted):
        g_k = int((counts_sorted == k).sum())
        k = int(k)
        bidx.append(slots_s[mpos : mpos + g_k * k].reshape(g_k, k))
        mpos += g_k * k
    if mpos != len(slots_s):
        raise ValueError("duplicate groups do not cover every boundary slot")
    return bidx


def make_tables(lvl: PatchLevel, dtype=torch.float32, device="cpu") -> LevelTables:
    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return LevelTables(
        owner=torch.as_tensor(lvl.owner, dtype=dtype, device=device),
        free=torch.as_tensor(lvl.free, dtype=dtype, device=device),
        gid=idx(np.moveaxis(lvl.gid, 0, -1)),
        bslots=idx(lvl.bslots),
        bseg=idx(lvl.bseg),
        nseg=int(lvl.nseg),
        dfg_bidx=tuple(idx(b) for b in _df_group_tables(lvl)),
    )


def exchange_sum(lvl: PatchLevel, x, tab: LevelTables | None = None):
    """additive -> consistent: sum duplicated boundary sites (segment sum
    over the boundary slots; UG4's change_storage_type_to_consistent).
    On the GPU index_add_ adds group members in atomic order, so the last
    bit of a 3+-member group may vary from run to run."""
    if tab is None:
        tab = make_tables(lvl, x.dtype, x.device)
    C = x.shape[0]
    xf = x.reshape(C, -1)
    s = xf.new_zeros((C, tab.nseg)).index_add_(1, tab.bseg, xf[:, tab.bslots])
    out = xf.clone()
    out[:, tab.bslots] = s[:, tab.bseg]
    return out.reshape(x.shape)


def exchange_sum_df(tab: LevelTables, xh, xl):
    """additive -> consistent for a double-float pair, ERROR-FREE: each
    duplicate group is gathered from its bucket table and folded with
    two_sum in a fixed order, so the consistent sum is exact to O(eps^2)
    and deterministic (an index_add_ of the parts would add in atomic,
    run-dependent order and lose exactness).  Every slot belongs to one
    group, so the write-back is a plain indexed store."""
    if not tab.dfg_bidx:
        return xh, xl
    C = xh.shape[0]
    xfh = xh.reshape(C, -1)
    xfl = xl.reshape(C, -1)
    outh = xfh.clone()
    outl = xfl.clone()
    for idx in tab.dfg_bidx:  # (g_k, k)
        vh = xfh[:, idx]  # (C, g_k, k)
        vl = xfl[:, idx]
        sh, sl = vh[..., 0], vl[..., 0]
        for j in range(1, idx.shape[1]):
            sh, e = df.two_sum(sh, vh[..., j])
            sl = sl + e + vl[..., j]
        sh, sl = df.two_sum(sh, sl)
        outh[:, idx] = sh[..., None].expand(vh.shape)
        outl[:, idx] = sl[..., None].expand(vl.shape)
    return outh.reshape(xh.shape), outl.reshape(xl.shape)


def owner_dot(lvl: PatchLevel, x, y, tab: LevelTables | None = None):
    """Global inner product of two consistent patch vectors (0-d tensor)."""
    if tab is not None:
        w = tab.owner.to(x.dtype)
    else:
        w = torch.as_tensor(lvl.owner, dtype=x.dtype, device=x.device)
    return torch.sum(x * y * w[None])


def to_patch(lvl: PatchLevel, v_global):
    """global (C, V) consistent -> patch (C, *lat, P)."""
    g = torch.as_tensor(
        np.moveaxis(lvl.gid, 0, -1).astype(np.int64), device=v_global.device
    )
    return v_global[:, g].contiguous()


def from_patch(lvl: PatchLevel, x, n_vertices: int, mode: str = "owner"):
    """patch (C, *lat, P) -> global (C, V).  mode "owner": pick each
    site's owning copy (consistent input); "sum": sum all copies
    (additive input)."""
    C = x.shape[0]
    gid = torch.as_tensor(
        np.moveaxis(lvl.gid, 0, -1).reshape(-1).astype(np.int64), device=x.device
    )
    xf = x.reshape(C, -1)
    if mode == "owner":
        xf = xf * torch.as_tensor(lvl.owner, dtype=x.dtype, device=x.device).reshape(1, -1)
    return xf.new_zeros((C, n_vertices)).index_add_(1, gid, xf)


def to_patch_tab(tab: LevelTables, v_global):
    """global (C, V) consistent -> patch (C, *lat, P)."""
    return v_global[:, tab.gid].contiguous()


def from_patch_tab(tab: LevelTables, x, n_vertices: int, mode: str = "owner"):
    """patch (C, *lat, P) -> global (C, V) (the base-solve glue).  In
    "owner" mode every vertex receives one nonzero copy, so the add order
    cannot change the result."""
    C = x.shape[0]
    xf = x.reshape(C, -1)
    if mode == "owner":
        xf = xf * tab.owner.to(x.dtype).reshape(1, -1)
    return xf.new_zeros((C, n_vertices)).index_add_(1, tab.gid.reshape(-1), xf)


# ---------------------------------------------------------------------------
# MG transfers (parity-strided slicing; see core.patches gid rule)
# ---------------------------------------------------------------------------

def _parity_slices(dim, pc, m):
    """(new-lattice odd-site slices, parent1 slices, parent2 slices) for
    parity class pc on the coarse lattice of size m+1."""
    h = [(pc >> (dim - 1 - a)) & 1 for a in range(dim)]
    sl_new = tuple(slice(hh, None, 2) for hh in h)
    sl_p1 = tuple(slice(0, m + 1 - hh) for hh in h)
    sl_p2 = tuple(slice(hh, m + 1) for hh in h)
    return sl_new, sl_p1, sl_p2


def prolong_p(ps: PatchSet, level_coarse: int, xc):
    """consistent coarse (C, *latc, P) -> consistent fine (C, *latf, P):
    copy even sites, average the two edge parents at odd sites."""
    dim = ps.dim
    m = ps.levels[level_coarse].m
    latf = tuple(2 * m + 1 for _ in range(dim))
    xf = xc.new_zeros(xc.shape[:1] + latf + xc.shape[-1:])
    pre = (slice(None),)
    xf[pre + tuple(slice(0, None, 2) for _ in range(dim))] = xc
    for pc in range(1, 2**dim):
        sl_new, sl_p1, sl_p2 = _parity_slices(dim, pc, m)
        xf[pre + sl_new] = 0.5 * (xc[pre + sl_p1] + xc[pre + sl_p2])
    return xf


def restrict_p(ps: PatchSet, level_coarse: int, rf):
    """additive fine (C, *latf, P) -> additive coarse (transpose of
    prolong_p)."""
    dim = ps.dim
    m = ps.levels[level_coarse].m
    pre = (slice(None),)
    rc = rf[pre + tuple(slice(0, None, 2) for _ in range(dim))].clone()
    for pc in range(1, 2**dim):
        sl_new, sl_p1, sl_p2 = _parity_slices(dim, pc, m)
        odd = 0.5 * rf[pre + sl_new]
        rc[pre + sl_p1] += odd
        rc[pre + sl_p2] += odd
    return rc
