"""Block-ELL operator pieces the patch MG needs for its level-0 base solve
(port of admm_optim_tpu/ops/sparsity.py: Pattern, build_pattern,
assemble_values, bake_dirichlet, to_dense).

Layouts as in the JAX package: ``cols (K, N)`` padded with the row index
itself; block values ``vals (C, C, K, N)``; element matrices
``(C, C, nl, nl, E)`` scattered to k-major flat slots ``k*N + n``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Pattern:
    """Static (host) part of a block-ELL operator."""

    n_rows: int
    block: int  # block size C (components per row)
    cols: np.ndarray  # (K, N) int32
    slots: np.ndarray  # (nl*nl*E,) int32 flat k-major index into (K*N)
    diag_k: np.ndarray  # (N,) int32: k position of the diagonal in each row
    nl: int  # local dofs per element

    @property
    def K(self) -> int:
        return self.cols.shape[0]


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
    """elem_mats (C, C, nl, nl, E) -> vals (C, C, K, N)."""
    C = pat.block
    E = elem_mats.shape[-1]
    flat = elem_mats.reshape(C * C, pat.nl * pat.nl * E)
    slots = torch.as_tensor(pat.slots, dtype=torch.int64, device=flat.device)
    out = flat.new_zeros((C * C, pat.n_rows * pat.K)).index_add_(1, slots, flat)
    return out.reshape(C, C, pat.K, pat.n_rows)


def bake_dirichlet(pat: Pattern, vals, fixed):
    """Zero constrained rows and columns and put 1 on their diagonal;
    fixed (C, N) bool (DirichletBoundary + adjust_solution)."""
    C, _, K, N = vals.shape
    dev = vals.device
    cols = torch.as_tensor(pat.cols, dtype=torch.int64, device=dev)  # (K, N)
    row_fix = fixed[:, None, None, :]  # (C,1,1,N) test component c fixed
    col_fix = fixed[:, cols][None]  # (1,C,K,N) trial component d fixed
    vals = torch.where(row_fix | col_fix, torch.zeros((), dtype=vals.dtype, device=dev), vals)
    diag_k = torch.as_tensor(pat.diag_k, dtype=torch.int64, device=dev)  # (N,)
    onehot_k = diag_k[None, :] == torch.arange(K, device=dev)[:, None]  # (K, N)
    eye = torch.eye(C, dtype=vals.dtype, device=dev)[:, :, None, None]  # (C,C,1,1)
    fix_cd = (fixed[:, None, :] | fixed[None, :, :])[:, :, None, :]  # (C,C,1,N)
    return torch.where(onehot_k[None, None] & fix_cd, eye, vals)


def to_dense(pat: Pattern, vals):
    """Densify to (C*N, C*N) in component-major flat ordering (the
    level-0 direct solve)."""
    C, _, K, N = vals.shape
    dev = vals.device
    cols = torch.as_tensor(pat.cols, dtype=torch.int64, device=dev)
    rows = torch.arange(N, device=dev)
    dense = vals.new_zeros((N, N, C, C))  # [row, col, c, d]
    for k in range(K):
        dense.index_put_((rows, cols[k]), vals[:, :, k, :].permute(2, 0, 1), accumulate=True)
    return dense.permute(2, 0, 3, 1).reshape(C * N, C * N)
