"""ctypes bindings for the native meshkit runtime (native/meshkit.cpp).

Provides the C++ fast path for the host-side topology setup (edge tables,
block-ELL pattern/scatter-map building) with automatic build-on-first-use
and a transparent numpy fallback.  Contract is identical to the numpy
implementations in core.mesh / ops.sparsity and is cross-checked in
tests/test_meshkit.py.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load() -> ctypes.CDLL | None:
    """Load (building if necessary) libmeshkit.so; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("ADMM_OPTIM_NO_NATIVE"):
        return None
    so = os.path.join(_repo_root(), "native", "libmeshkit.so")
    if not os.path.exists(so):
        try:
            subprocess.run(
                ["make", "-C", os.path.dirname(so), "-s"],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.mk_edge_table.restype = ctypes.c_void_p
    lib.mk_edge_table.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i32p, ctypes.c_int32]
    lib.mk_edge_count.restype = ctypes.c_int64
    lib.mk_edge_count.argtypes = [ctypes.c_void_p]
    lib.mk_edge_get.argtypes = [ctypes.c_void_p, i32p, i32p]
    lib.mk_edge_free.argtypes = [ctypes.c_void_p]
    lib.mk_pattern.restype = ctypes.c_void_p
    lib.mk_pattern.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64]
    lib.mk_pattern_K.restype = ctypes.c_int64
    lib.mk_pattern_K.argtypes = [ctypes.c_void_p]
    lib.mk_pattern_get.argtypes = [ctypes.c_void_p, i32p, i32p, i32p]
    lib.mk_pattern_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def edge_table(elems: np.ndarray, loc_pairs: np.ndarray):
    """(edges (Ne,2), elem_edges (E, n_loc)) or None if native unavailable."""
    lib = load()
    if lib is None:
        return None
    elems = np.ascontiguousarray(elems, dtype=np.int32)
    loc = np.ascontiguousarray(loc_pairs, dtype=np.int32)
    E, nl = elems.shape
    n_loc = len(loc)
    h = lib.mk_edge_table(_ptr(elems), E, nl, _ptr(loc), n_loc)
    ne = lib.mk_edge_count(h)
    edges = np.empty((ne, 2), dtype=np.int32)
    elem_edges = np.empty((E, n_loc), dtype=np.int32)
    lib.mk_edge_get(h, _ptr(edges), _ptr(elem_edges))
    lib.mk_edge_free(h)
    return edges, elem_edges


def pattern(elem_dofs: np.ndarray, n_rows: int):
    """(cols (K,N), slots, diag_k) or None if native unavailable."""
    lib = load()
    if lib is None:
        return None
    elem_dofs = np.ascontiguousarray(elem_dofs, dtype=np.int32)
    E, nl = elem_dofs.shape
    h = lib.mk_pattern(_ptr(elem_dofs), E, nl, n_rows)
    K = lib.mk_pattern_K(h)
    cols = np.empty((K, n_rows), dtype=np.int32)
    slots = np.empty(E * nl * nl, dtype=np.int32)
    diag_k = np.empty(n_rows, dtype=np.int32)
    lib.mk_pattern_get(h, _ptr(cols), _ptr(slots), _ptr(diag_k))
    lib.mk_pattern_free(h)
    return cols, slots, diag_k
