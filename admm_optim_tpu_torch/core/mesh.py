"""Simplex mesh topology + uniform refinement hierarchies.

TPU-native replacement for the UG4 ``Domain`` / ``GlobalDomainRefiner`` /
``util.refinement.CreateRegularHierarchy`` stack (reference 2d_admm.lua:131-209).
The reference refines unstructured simplex grids uniformly (red refinement)
and redistributes over MPI ranks with ParMETIS; here every level is a set of
flat arrays (coords, elements, edges) so that all downstream FE operations are
batched dense ops on TPU, and partitioning is handled by ``jax.sharding``
instead of a graph partitioner (see parallel/).

Key invariants of the hierarchy (exploited everywhere downstream):
 * Level l+1 vertices ``0..V_l-1`` *are* the level-l vertices (injection).
 * Vertex ``V_l + e`` of level l+1 is the midpoint of level-l edge ``e``.
 * ``parents[v] = (a, b)`` with the midpoint convention that an original
   vertex has ``parents = (v, v)`` so P1 prolongation is uniformly
   ``x_fine[v] = 0.5*(x_coarse[a] + x_coarse[b])``.

2D: each triangle splits into 4 children.  3D: each tetrahedron splits into
8 children using Bey's rule (diagonal through midpoints of local edges
(0,2) and (1,3)).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .ugx import UgxGrid, read_ugx

# local edge orderings (combinations order)
TRI_EDGES = np.array(list(itertools.combinations(range(3), 2)), dtype=np.int32)
TET_EDGES = np.array(list(itertools.combinations(range(4), 2)), dtype=np.int32)


def _edge_table(pairs: np.ndarray) -> np.ndarray:
    """Unique sorted vertex pairs, lexicographically ordered. (Ne,2) int32."""
    pairs = np.sort(pairs.reshape(-1, 2), axis=1)
    return np.unique(pairs, axis=0).astype(np.int32)


def _edges_and_elem_edges(coords, elems):
    """(edges, elem_edges) via the native meshkit runtime when available."""
    from . import meshkit

    loc = TET_EDGES if elems.shape[1] == 4 else TRI_EDGES
    native = meshkit.edge_table(elems, loc)
    if native is not None:
        return native
    edges = _edge_table(elems[:, loc].reshape(-1, 2))
    return edges, _edge_lookup(edges, np.sort(elems[:, loc], axis=-1))


def _edge_lookup(edges: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Map (n,2) sorted vertex pairs to edge ids via binary search."""
    vmax = int(edges.max()) + 2 if len(edges) else 1
    keys = edges[:, 0].astype(np.int64) * vmax + edges[:, 1]
    order = np.argsort(keys)
    q = np.sort(query.reshape(-1, 2), axis=1)
    qk = q[:, 0].astype(np.int64) * vmax + q[:, 1]
    pos = np.searchsorted(keys[order], qk)
    ids = order[np.clip(pos, 0, len(order) - 1)]
    if not np.all(keys[ids] == qk):
        raise ValueError("edge lookup failed: query pair not in edge table")
    return ids.astype(np.int32).reshape(query.shape[:-1])


def _orient_positive(coords: np.ndarray, elems: np.ndarray) -> np.ndarray:
    """Swap last two vertices of elements with negative signed volume."""
    d = coords.shape[1]
    v = coords[elems]
    if d == 2:
        det = np.linalg.det(v[:, 1:3] - v[:, :1])
    else:
        det = np.linalg.det(v[:, 1:4] - v[:, :1])
    flip = det < 0
    out = elems.copy()
    out[flip, -2], out[flip, -1] = elems[flip, -1], elems[flip, -2]
    return out


@dataclasses.dataclass
class MeshLevel:
    """One level of the refinement hierarchy (host-side numpy arrays)."""

    dim: int
    coords: np.ndarray  # (V, dim) float64
    elems: np.ndarray  # (E, dim+1) int32, positively oriented
    edges: np.ndarray  # (Ne, 2) int32, sorted pairs
    elem_edges: np.ndarray  # (E, n_edges_loc) int32
    parents: np.ndarray  # (V, 2) int32 - see module docstring
    subset_vertices: dict[str, np.ndarray]  # name -> bool (V,)
    subset_edges: dict[str, np.ndarray]  # name -> bool (Ne,)
    subset_elems: dict[str, np.ndarray]  # name -> bool (E,)
    # 3D only: boundary faces per subset as (Fs,3) vertex triples
    subset_faces: dict[str, np.ndarray]
    # optional brick-patch metadata (geomgen): (P, 2^dim) corner vertex ids in
    # (x-major bit order); elems are brick-contiguous (elems_per_brick each).
    # Enables the patch-stencil fast path (core.patches).
    bricks: np.ndarray | None = None
    elems_per_brick: int = 0

    @property
    def num_vertices(self) -> int:
        return len(self.coords)

    @property
    def num_elems(self) -> int:
        return len(self.elems)

    def vertex_mask(self, subset_names) -> np.ndarray:
        """Union of subset vertex masks (for Dirichlet rows etc.)."""
        m = np.zeros(self.num_vertices, dtype=bool)
        for name in subset_names:
            m |= self.subset_vertices[name]
        return m


def level_from_ugx(grid: UgxGrid) -> MeshLevel:
    dim = grid.dim
    coords = grid.coords[:, :dim].astype(np.float64)
    elems = (grid.tetrahedrons if dim == 3 else grid.triangles).astype(np.int32)
    elems = _orient_positive(coords, elems)
    edges, elem_edges = _edges_and_elem_edges(coords, elems)

    V, E, Ne = len(coords), len(elems), len(edges)
    sub_v, sub_e, sub_el, sub_f = {}, {}, {}, {}
    for name, info in grid.subsets.items():
        mv = np.zeros(V, dtype=bool)
        mv[info.vertices] = True
        sub_v[name] = mv
        # the file's edge indices refer to ITS edge list; remap to ours
        me = np.zeros(Ne, dtype=bool)
        if len(info.edges) and len(grid.edges):
            me[_edge_lookup(edges, grid.edges[info.edges])] = True
        sub_e[name] = me
        mel = np.zeros(E, dtype=bool)
        if dim == 2:
            if len(info.faces):
                mel[info.faces] = True
            sub_f[name] = np.zeros((0, 3), dtype=np.int32)
        else:
            if len(info.volumes):
                mel[info.volumes] = True
            sub_f[name] = (
                grid.triangles[info.faces].astype(np.int32)
                if len(info.faces)
                else np.zeros((0, 3), dtype=np.int32)
            )
        sub_el[name] = mel

    parents = np.stack([np.arange(V), np.arange(V)], axis=1).astype(np.int32)
    return MeshLevel(dim, coords, elems, edges, elem_edges, parents, sub_v, sub_e, sub_el, sub_f)


def refine(lvl: MeshLevel) -> MeshLevel:
    """Uniform red refinement of one level (tri->4 / tet->8, Bey's rule)."""
    dim, V, Ne = lvl.dim, lvl.num_vertices, len(lvl.edges)
    mid = lvl.coords[lvl.edges].mean(axis=1)
    coords = np.concatenate([lvl.coords, mid], axis=0)
    parents = np.concatenate([lvl.parents[:, :2] * 0 + np.arange(V)[:, None], lvl.edges], axis=0)
    parents[:V] = np.stack([np.arange(V)] * 2, axis=1)
    parents = parents.astype(np.int32)

    ee = lvl.elem_edges + V  # midpoint vertex index per local edge
    el = lvl.elems
    if dim == 2:
        a, b, c = el[:, 0], el[:, 1], el[:, 2]
        mab, mac, mbc = ee[:, 0], ee[:, 1], ee[:, 2]
        children = np.stack(
            [
                np.stack([a, mab, mac], 1),
                np.stack([mab, b, mbc], 1),
                np.stack([mac, mbc, c], 1),
                np.stack([mab, mbc, mac], 1),
            ],
            axis=1,
        )  # (E, 4, 3)
        nchild = 4
    else:
        x0, x1, x2, x3 = el[:, 0], el[:, 1], el[:, 2], el[:, 3]
        m01, m02, m03, m12, m13, m23 = (ee[:, i] for i in range(6))
        children = np.stack(
            [
                np.stack([x0, m01, m02, m03], 1),
                np.stack([m01, x1, m12, m13], 1),
                np.stack([m02, m12, x2, m23], 1),
                np.stack([m03, m13, m23, x3], 1),
                np.stack([m01, m02, m03, m13], 1),
                np.stack([m01, m02, m12, m13], 1),
                np.stack([m02, m03, m13, m23], 1),
                np.stack([m02, m12, m13, m23], 1),
            ],
            axis=1,
        )  # (E, 8, 4)
        nchild = 8
    # NOTE: children are NOT re-oriented.  Keeping the deterministic child
    # vertex order preserves Bey/red self-similarity, so brick/Kuhn meshes
    # have a translation-invariant element-class structure on the refined
    # lattice (6 classes / 15-point stencil in 3D) - the basis of the
    # patch-stencil fast path (core.patches).  All assembly uses the
    # unsigned measure |detJ| (ops.geometry), so orientation is free.
    elems = children.reshape(-1, dim + 1).astype(np.int32)

    edges, elem_edges = _edges_and_elem_edges(coords, elems)

    # ---- subset propagation ------------------------------------------------
    # classify new edges: (i) children of old edges: exactly one endpoint < V
    # and midpoint's parents == {other endpoint, x}; (ii) interior edges:
    # both endpoints are midpoints (>= V) or connect within a face/volume.
    sub_v, sub_e, sub_el, sub_f = {}, {}, {}, {}
    lo, hi = edges[:, 0], edges[:, 1]
    # an edge (p, m) with p < V <= m is a child of old edge e=m-V iff p is an
    # endpoint of that edge
    child_of = np.full(len(edges), -1, dtype=np.int64)
    cand = (lo < V) & (hi >= V)
    pe = lvl.edges[np.clip(hi - V, 0, Ne - 1)]
    is_child = cand & ((pe[:, 0] == lo) | (pe[:, 1] == lo))
    child_of[is_child] = hi[is_child] - V

    # edges with both endpoints >= V lie inside an old face (2D: inside a
    # triangle; 3D: inside a face or the octahedron interior).
    for name in lvl.subset_vertices:
        mv = np.zeros(len(coords), dtype=bool)
        mv[: V] = lvl.subset_vertices[name]
        mv[V:] = lvl.subset_edges[name][np.arange(Ne)]  # midpoint of subset edge
        sub_v[name] = mv

        me = np.zeros(len(edges), dtype=bool)
        mask_c = child_of >= 0
        me[mask_c] = lvl.subset_edges[name][child_of[mask_c]]
        sub_e[name] = me  # face-interior edges handled below

        mel = np.repeat(lvl.subset_elems[name], nchild)
        sub_el[name] = mel

    if dim == 2:
        # triangle-interior edges (both endpoints midpoints of same tri)
        # belong to the tri's face subset
        for name in lvl.subset_vertices:
            if not lvl.subset_elems[name].any():
                sub_f[name] = np.zeros((0, 3), dtype=np.int32)
                continue
            tris = lvl.elems[lvl.subset_elems[name]]
            tee = lvl.elem_edges[lvl.subset_elems[name]] + V
            inner = np.stack([tee[:, [0, 1]], tee[:, [0, 2]], tee[:, [1, 2]]], 1).reshape(-1, 2)
            sub_e[name][_edge_lookup(edges, inner)] = True
            sub_f[name] = np.zeros((0, 3), dtype=np.int32)
            del tris
    else:
        # 3D: refine the per-subset boundary faces, tag their interior edges
        for name, faces in lvl.subset_faces.items():
            if len(faces) == 0:
                sub_f[name] = np.zeros((0, 3), dtype=np.int32)
                continue
            fe = _edge_lookup(lvl.edges, np.sort(faces[:, TRI_EDGES], axis=-1)) + V
            fa, fb, fc = faces[:, 0], faces[:, 1], faces[:, 2]
            mab, mac, mbc = fe[:, 0], fe[:, 1], fe[:, 2]
            kids = np.stack(
                [
                    np.stack([fa, mab, mac], 1),
                    np.stack([mab, fb, mbc], 1),
                    np.stack([mac, mbc, fc], 1),
                    np.stack([mab, mbc, mac], 1),
                ],
                axis=1,
            ).reshape(-1, 3)
            sub_f[name] = kids.astype(np.int32)
            inner = np.stack([fe[:, [0, 1]], fe[:, [0, 2]], fe[:, [1, 2]]], 1).reshape(-1, 2)
            sub_e[name][_edge_lookup(edges, inner)] = True

    return MeshLevel(dim, coords, elems, edges, elem_edges, parents, sub_v, sub_e, sub_el, sub_f)


@dataclasses.dataclass
class Hierarchy:
    """A full refinement hierarchy, levels[0] = coarsest."""

    levels: list[MeshLevel]

    @property
    def dim(self) -> int:
        return self.levels[0].dim

    @property
    def fine(self) -> MeshLevel:
        return self.levels[-1]

    @classmethod
    def from_ugx(cls, path: str, num_refs: int) -> "Hierarchy":
        levels = [level_from_ugx(read_ugx(path))]
        for _ in range(num_refs):
            levels.append(refine(levels[-1]))
        return cls(levels)

    def describe(self) -> str:
        rows = []
        for i, l in enumerate(self.levels):
            rows.append(
                f"level {i}: V={l.num_vertices} E={l.num_elems} edges={len(l.edges)}"
            )
        return "\n".join(rows)
