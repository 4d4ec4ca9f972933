"""Block-ELL sparse operators with precomputed FE assembly maps (port of
admm_optim_tpu/ops/sparsity.py): the global backend's operators and the
patch MG's level-0 base solve.

Layouts as in the JAX package: ``cols (K, N)`` padded with the row index
itself; block values ``vals (C, C, K, N)``; element matrices
``(C, C, nl, nl, E)`` scattered to k-major flat slots ``k*N + n``; fields
flat component-major ``x (C*N,) == X(C, N).ravel()``.  Every apply also
takes leading lane axes.

Two things the JAX package leaves to XLA are explicit here:
  * every segment sum (the assembly scatter, restriction, the ELL Jacobian
    applies) goes through a ``SegmentSum`` plan: on the GPU the
    contributions of each output row are gathered from a host-built table
    and summed along a fixed axis, so a run adds them in one order every
    time, where ``index_add_`` would add them in atomic order; on the CPU
    it is ``index_add_``, which adds them in index order;
  * ``linear_call`` is the JAX ``custom_derivatives.linear_call``: a linear
    map whose backward is a given transpose, so that autograd through a
    gather (``transpose_M``'s recorded V-cycle) replays the transpose as
    another gather instead of a scatter.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


# ---------------------------------------------------------------------------
# deterministic segment sums
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class SegmentSum:
    """out[..., n] = sum of src[..., m] over the m with ids[m] == n.

    The fixed-order form (gather_sum): the output rows are bucketed by
    their number of contributions, rounded up to a power of two; each
    bucket is a (cap, rows) table of source positions, padded with n_src
    (a zero appended to the source), summed along the cap axis.  ``inv``
    puts the buckets' rows back in order.  At most twice the source's
    entries are read.  A CPU tensor takes index_add_ instead (index_sum),
    the order the CPU tests have always held."""

    n_src: int
    n_out: int
    ids: np.ndarray  # (n_src,) int64 output row of each source entry
    buckets: tuple  # of (cap, rows) int64 numpy tables
    inv: np.ndarray  # (n_out,) position of each output row in the bucket concatenation
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def tables(self, device):
        key = torch.device(device)
        if key not in self._dev:
            self._dev[key] = (
                tuple(torch.as_tensor(b, device=device) for b in self.buckets),
                torch.as_tensor(self.inv, device=device),
                torch.as_tensor(self.ids, device=device),
            )
        return self._dev[key]

    def gather_sum(self, src):
        buckets, inv, _ = self.tables(src.device)
        srcp = torch.cat([src, src.new_zeros(src.shape[:-1] + (1,))], dim=-1)
        parts = [srcp[..., b].sum(dim=-2) for b in buckets]
        return torch.cat(parts, dim=-1)[..., inv]

    def index_sum(self, src):
        ids = self.tables(src.device)[2]
        out = src.new_zeros(src.shape[:-1] + (self.n_out,))
        return out.index_add_(out.dim() - 1, ids, src)

    def __call__(self, src):
        """src (..., n_src) -> (..., n_out)."""
        return self.gather_sum(src) if src.is_cuda else self.index_sum(src)


def segment_plan(ids: np.ndarray, n_out: int) -> SegmentSum:
    """The SegmentSum of ids (M,) into n_out rows; each row's contributions
    are summed in the order of their position in ids."""
    ids = np.asarray(ids, np.int64).ravel()
    M = ids.shape[0]
    order = np.argsort(ids, kind="stable")
    counts = np.bincount(ids, minlength=n_out)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cap = np.ones(n_out, np.int64)
    nz = counts > 1
    cap[nz] = 1 << np.ceil(np.log2(counts[nz])).astype(np.int64)
    buckets, rows_all = [], []
    for c in np.unique(cap):
        rows = np.nonzero(cap == c)[0]
        j = np.arange(c)[:, None]
        take = j < counts[rows][None, :]
        pos = np.where(take, starts[rows][None, :] + j, 0)
        buckets.append(np.where(take, order[np.minimum(pos, max(M - 1, 0))], M).astype(np.int64))
        rows_all.append(rows)
    inv = np.empty(n_out, np.int64)
    inv[np.concatenate(rows_all)] = np.arange(n_out)
    return SegmentSum(M, n_out, ids, tuple(buckets), inv)


class _LinearCall(torch.autograd.Function):
    """y = fwd(x) for a linear fwd, with trans(ct) as its backward."""

    @staticmethod
    def forward(ctx, fwd, trans, x):
        ctx.trans = trans
        return fwd(x)

    @staticmethod
    def backward(ctx, ct):
        return None, None, ctx.trans(ct)


def linear_call(fwd, trans, x):
    """fwd(x) whose autograd transpose is trans, the exact transpose of the
    linear map fwd (jax.custom_derivatives.linear_call).  Outside autograd
    it is fwd(x)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return fwd(x)
    return _LinearCall.apply(fwd, trans, x)


@dataclasses.dataclass(frozen=True)
class Pattern:
    """Static (host) part of a block-ELL operator."""

    n_rows: int
    block: int  # block size C (components per row)
    cols: np.ndarray  # (K, N) int32
    slots: np.ndarray  # (nl*nl*E,) int32 flat k-major index into (K*N)
    diag_k: np.ndarray  # (N,) int32: k position of the diagonal in each row
    nl: int  # local dofs per element
    _dev: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def K(self) -> int:
        return self.cols.shape[0]

    @property
    def n_flat(self) -> int:
        return self.n_rows * self.block

    def cols_t(self, device) -> torch.Tensor:
        """cols as an int64 tensor on device (cached)."""
        key = ("cols", torch.device(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.cols.astype(np.int64), device=device)
        return self._dev[key]

    def diag_t(self, device) -> torch.Tensor:
        key = ("diag_k", torch.device(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.diag_k.astype(np.int64), device=device)
        return self._dev[key]

    @property
    def slot_plan(self) -> SegmentSum:
        """The assembly scatter map as a SegmentSum (built once)."""
        if "slot_plan" not in self._dev:
            self._dev["slot_plan"] = segment_plan(self.slots, self.n_rows * self.K)
        return self._dev["slot_plan"]


def build_pattern(elem_dofs: np.ndarray, n_rows: int, block: int) -> Pattern:
    """elem_dofs: (E, nl) int -> ELL pattern + assembly scatter map, ordered
    (i, j, e) with e minor-most.  Native meshkit when it builds, numpy
    otherwise (same contract)."""
    E, nl = elem_dofs.shape
    from ..core import meshkit

    native = meshkit.pattern(elem_dofs, n_rows)
    if native is not None:
        cols, slots, diag_k = native
        return Pattern(
            n_rows=n_rows, block=block, cols=cols, slots=slots, diag_k=diag_k, nl=nl
        )
    rows = elem_dofs.T[:, None, :].repeat(nl, 1).ravel().astype(np.int64)  # (nl,nl,E)
    cols = elem_dofs.T[None, :, :].repeat(nl, 0).ravel().astype(np.int64)
    key = rows * n_rows + cols
    uniq = np.unique(key)
    diag_keys = np.arange(n_rows, dtype=np.int64) * n_rows + np.arange(n_rows)
    uniq = np.unique(np.concatenate([uniq, diag_keys]))
    urow = uniq // n_rows
    row_start = np.searchsorted(urow, np.arange(n_rows))
    pos_in_row = np.arange(len(uniq)) - row_start[urow]
    counts = np.bincount(urow, minlength=n_rows)
    K = int(counts.max())
    cols_pad = np.tile(np.arange(n_rows, dtype=np.int64)[None, :], (K, 1))  # (K, N)
    cols_pad[pos_in_row, urow] = uniq % n_rows
    uslot = pos_in_row * n_rows + urow  # k-major flat slot
    idx = np.searchsorted(uniq, key)
    slots = uslot[idx]
    dpos = np.searchsorted(uniq, diag_keys)
    diag_k = pos_in_row[dpos]
    return Pattern(
        n_rows=n_rows,
        block=block,
        cols=cols_pad.astype(np.int32),
        slots=slots.astype(np.int32),
        diag_k=diag_k.astype(np.int32),
        nl=nl,
    )


def assemble_values(pat: Pattern, elem_mats):
    """elem_mats (C, C, nl, nl, E) -> vals (C, C, K, N), summed in a fixed
    order (Pattern.slot_plan).

    Convention: ``elem_mats[c, d, i, j, e]`` couples test dof (i, c) with
    trial dof (j, d) of element e."""
    C = pat.block
    E = elem_mats.shape[-1]
    flat = elem_mats.reshape(C * C, pat.nl * pat.nl * E)
    return pat.slot_plan(flat).reshape(C, C, pat.K, pat.n_rows)


def bake_dirichlet(pat: Pattern, vals, fixed):
    """Zero constrained rows and columns and put 1 on their diagonal;
    fixed (C, N) bool (DirichletBoundary + adjust_solution)."""
    C, _, K, N = vals.shape
    dev = vals.device
    cols = pat.cols_t(dev)  # (K, N)
    row_fix = fixed[:, None, None, :]  # (C,1,1,N) test component c fixed
    col_fix = fixed[:, cols][None]  # (1,C,K,N) trial component d fixed
    vals = torch.where(row_fix | col_fix, torch.zeros((), dtype=vals.dtype, device=dev), vals)
    onehot_k = pat.diag_t(dev)[None, :] == torch.arange(K, device=dev)[:, None]  # (K, N)
    eye = torch.eye(C, dtype=vals.dtype, device=dev)[:, :, None, None]  # (C,C,1,1)
    fix_cd = (fixed[:, None, :] | fixed[None, :, :])[:, :, None, :]  # (C,C,1,N)
    return torch.where(onehot_k[None, None] & fix_cd, eye, vals)


def to_dense(pat: Pattern, vals):
    """Densify to (C*N, C*N) in component-major flat ordering (the
    level-0 direct solve)."""
    C, _, K, N = vals.shape
    dev = vals.device
    cols = pat.cols_t(dev)
    rows = torch.arange(N, device=dev)
    dense = vals.new_zeros((N, N, C, C))  # [row, col, c, d]
    for k in range(K):
        dense.index_put_((rows, cols[k]), vals[:, :, k, :].permute(2, 0, 1), accumulate=True)
    return dense.permute(2, 0, 3, 1).reshape(C * N, C * N)


def spmv_cn(pat: Pattern, vals, x_cn):
    """y (..., C, N) = A @ x with x (..., C, N)."""
    xg = x_cn[..., pat.cols_t(x_cn.device)]  # (..., C, K, N)
    return torch.einsum("cdkn,...dkn->...cn", vals, xg)


def spmv_flat(pat: Pattern, vals, x):
    """y (..., C*N) = A @ x (..., C*N), component-major flat layout."""
    C, N = pat.block, pat.n_rows
    lead = x.shape[:-1]
    return spmv_cn(pat, vals, x.reshape(lead + (C, N))).reshape(lead + (C * N,))


def spmv(pat: Pattern, vals, x):
    """Compatibility wrapper: x (N, C) -> y (N, C)."""
    return spmv_cn(pat, vals, x.T).T


def diag_cn(pat: Pattern, vals):
    """(C, N) scalar diagonal."""
    C, _, K, N = vals.shape
    onehot_k = (pat.diag_t(vals.device)[None, :] == torch.arange(K, device=vals.device)[:, None]).to(vals.dtype)
    dblocks = torch.einsum("cdkn,kn->cdn", vals, onehot_k)  # (C,C,N)
    return torch.diagonal(dblocks, dim1=0, dim2=1).T  # (C, N)


# ---- explicit transpose ---------------------------------------------------
#
# The adjoint NS solve preconditions J^T with the transpose of the forward
# block preconditioner (solvers.ns_solver.transpose_M), recorded under
# autograd.  Autograd transposes the gather-based spmv into a scatter
# (index_add_, atomic on the GPU), so the values of A^T are precomputed in
# the same pattern (ELL patterns built from element connectivity are
# structurally symmetric) and spmv_flat_pair runs them through the same
# gather in the backward pass.


def transpose_map(pat: Pattern):
    """Host-precomputed mapping for in-pattern transposition:
    (k_src (K, N), n_src (K, N), valid (K, N) bool) with
    ``vals_T[c, d, k, n] = vals[d, c, k_src, n_src]`` where valid, 0 on the
    padding slots.  Raises on a pattern that is not structurally
    symmetric."""
    cols = np.asarray(pat.cols, dtype=np.int64)  # (K, N)
    K, N = cols.shape
    diag_k = np.asarray(pat.diag_k, dtype=np.int64)
    nn = np.broadcast_to(np.arange(N, dtype=np.int64)[None, :], (K, N))
    kk = np.broadcast_to(np.arange(K, dtype=np.int64)[:, None], (K, N))
    valid = (cols != nn) | (kk == diag_k[None, :])
    # real-slot lookup sorted by (row * N + col)
    skey = nn[valid] * N + cols[valid]
    order = np.argsort(skey)
    skey_s = skey[order]
    k_s = kk[valid][order]
    # query: transpose of slot (k, n) lives at row cols[k, n], col n
    tkey = cols * N + nn
    idx = np.clip(np.searchsorted(skey_s, tkey.ravel()).reshape(K, N), 0, len(skey_s) - 1)
    found = skey_s[idx] == tkey
    if not np.all(found[valid]):
        raise ValueError("pattern is not structurally symmetric")
    k_src = np.where(valid, k_s[idx], 0)
    n_src = np.where(valid, cols, 0)
    return k_src.astype(np.int32), n_src.astype(np.int32), valid


def transpose_values(pat: Pattern, vals, tmap=None):
    """vals (C, C, K, N) of A -> values of A^T in the same pattern."""
    if tmap is None:
        tmap = transpose_map(pat)
    k_src, n_src, valid = tmap
    dev = vals.device
    vT = vals.transpose(0, 1)[:, :, torch.as_tensor(k_src.astype(np.int64), device=dev),
                              torch.as_tensor(n_src.astype(np.int64), device=dev)]
    return torch.where(torch.as_tensor(valid, device=dev)[None, None], vT, torch.zeros((), dtype=vals.dtype, device=dev))


def spmv_flat_pair(pat: Pattern, vals, vals_t, x):
    """y = A x whose autograd backward is the gather-based spmv on the
    pre-transposed values vals_t, not the scatter autograd would make of
    the forward gather.  Exact in both directions."""
    return linear_call(lambda v: spmv_flat(pat, vals, v), lambda ct: spmv_flat(pat, vals_t, ct), x)


# ---- field layout helpers -------------------------------------------------

def to_flat(u_vc):
    """(V, C) field -> flat component-major (C*V,)."""
    return u_vc.T.reshape(-1)


def from_flat(x, n_rows: int):
    """flat (C*V,) -> (V, C)."""
    return x.reshape(-1, n_rows).T
