"""The benchmark's input mesh: a frozen copy of the port's host mesh code
(``core/geomgen.channel_3d`` and ``core/mesh.refine``, 3D only, numpy
only), with an on-disk cache of the refined levels.

The arrays it makes are the ones the port's own generator makes, element
for element and edge for edge (``tests/test_bench_mesh.py`` holds them
equal at refs <= 2); the edge tables are built from int64 pair keys, which
gives the same lexicographic order as the port's ``np.unique(axis=0)`` in
a fraction of the time.  Nothing here imports the port: later changes to
the port's mesh code do not move the benchmark's input.

Cache: ``benchmark/.cache/mesh/<sha>-r<refs>/`` holds one ``.npz`` per
level, keyed by the SHA-256 of this file, so only a checkout's first run
of a size refines.  ``load_levels`` returns plain dicts of arrays; the
harness builds the port's ``MeshLevel`` / ``Hierarchy`` from them.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import pathlib
import time

import numpy as np

EPS = 1e-9
TRI_EDGES = np.array(list(itertools.combinations(range(3), 2)), dtype=np.int32)
TET_EDGES = np.array(list(itertools.combinations(range(4), 2)), dtype=np.int32)
SUBSETS = ("inlet", "outlet", "wall", "obstacle_surface", "outer")

CACHE_DIR = pathlib.Path(__file__).resolve().parent / ".cache" / "mesh"


def source_hash() -> str:
    return hashlib.sha256(pathlib.Path(__file__).read_bytes()).hexdigest()


# ---------------------------------------------------------------------------
# edge tables
# ---------------------------------------------------------------------------

def _pair_keys(pairs: np.ndarray, n_vertices: int) -> np.ndarray:
    """Sorted (lo, hi) vertex pairs -> int64 keys lo * V + hi, whose order
    is the lexicographic order of the pairs."""
    return pairs[..., 0].astype(np.int64) * n_vertices + pairs[..., 1]


def edges_and_elem_edges(elems: np.ndarray, n_vertices: int):
    """(edges (Ne, 2) int32 lexicographically sorted unique pairs,
    elem_edges (E, 6) int32 edge id of each local edge)."""
    pairs = np.sort(elems[:, TET_EDGES], axis=-1)  # (E, 6, 2)
    keys = _pair_keys(pairs, n_vertices)
    del pairs
    uniq, inv = np.unique(keys.reshape(-1), return_inverse=True)
    edges = np.stack([uniq // n_vertices, uniq % n_vertices], axis=1).astype(np.int32)
    return edges, inv.reshape(keys.shape).astype(np.int32)


def edge_lookup(edges: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Edge ids of (..., 2) vertex pairs; raises if one is not an edge."""
    n = int(edges.max()) + 2 if len(edges) else 1
    keys = _pair_keys(edges, n)  # sorted, as edges are
    q = _pair_keys(np.sort(query.reshape(-1, 2), axis=1), n)
    pos = np.clip(np.searchsorted(keys, q), 0, len(keys) - 1)
    if not np.all(keys[pos] == q):
        raise ValueError("edge lookup failed: query pair not in edge table")
    return pos.astype(np.int32).reshape(query.shape[:-1])


# ---------------------------------------------------------------------------
# level 0: the geomgen 3D channel
# ---------------------------------------------------------------------------

def _tag_subsets(coords, elems, edges, lo, hi, obs_lo, obs_hi):
    def on_plane(pts, axis, value):
        return np.abs(pts[:, axis] - value) < EPS

    def on_obstacle(pts):
        inside = np.all((pts >= obs_lo - EPS) & (pts <= obs_hi + EPS), axis=1)
        on_face = np.zeros(len(pts), dtype=bool)
        for ax in range(3):
            on_face |= on_plane(pts, ax, obs_lo[ax]) | on_plane(pts, ax, obs_hi[ax])
        return inside & on_face

    vmask = {"inlet": on_plane(coords, 0, lo[0]), "outlet": on_plane(coords, 0, hi[0])}
    wall = np.zeros(len(coords), dtype=bool)
    for ax in (1, 2):
        wall |= on_plane(coords, ax, lo[ax]) | on_plane(coords, ax, hi[ax])
    vmask["wall"] = wall & ~vmask["inlet"] & ~vmask["outlet"]
    vmask["obstacle_surface"] = on_obstacle(coords)
    vmask["outer"] = np.ones(len(coords), dtype=bool)

    emid = coords[edges].mean(axis=1)
    emask = {
        "obstacle_surface": on_obstacle(emid) & vmask["obstacle_surface"][edges].all(axis=1),
        "inlet": on_plane(emid, 0, lo[0]) & vmask["inlet"][edges].all(axis=1),
        "outlet": on_plane(emid, 0, hi[0]) & vmask["outlet"][edges].all(axis=1),
    }
    wall_e = np.zeros(len(edges), dtype=bool)
    for ax in (1, 2):
        wall_e |= on_plane(emid, ax, lo[ax]) | on_plane(emid, ax, hi[ax])
    emask["wall"] = wall_e & ~emask["inlet"] & ~emask["outlet"]
    emask["outer"] = np.ones(len(edges), dtype=bool)

    elmask = {name: np.zeros(len(elems), dtype=bool) for name in vmask}
    elmask["outer"][:] = True

    faces = np.concatenate([elems[:, [0, 1, 2]], elems[:, [0, 1, 3]], elems[:, [0, 2, 3]], elems[:, [1, 2, 3]]])
    _, idx, cnt = np.unique(np.sort(faces, axis=1), axis=0, return_index=True, return_counts=True)
    bfaces = faces[idx[cnt == 1]]
    fmid = coords[bfaces].mean(axis=1)
    fdict = {name: np.zeros((0, 3), dtype=np.int32) for name in vmask}
    fdict["inlet"] = bfaces[on_plane(fmid, 0, lo[0])].astype(np.int32)
    fdict["outlet"] = bfaces[on_plane(fmid, 0, hi[0])].astype(np.int32)
    wf = np.zeros(len(bfaces), dtype=bool)
    for ax in (1, 2):
        wf |= on_plane(fmid, ax, lo[ax]) | on_plane(fmid, ax, hi[ax])
    fdict["wall"] = bfaces[wf].astype(np.int32)
    fdict["obstacle_surface"] = bfaces[on_obstacle(fmid)].astype(np.int32)
    return vmask, emask, elmask, fdict


def _axis(lo, hi, obs_lo, obs_hi, n_side):
    return np.concatenate([np.linspace(lo, obs_lo, n_side + 1), np.linspace(obs_hi, hi, n_side + 1)])


def _path_kuhn_tets() -> np.ndarray:
    """The 6 Kuhn tetrahedra of the unit cube in monotone-path vertex order."""
    tets = []
    for sig in itertools.permutations(range(3)):
        v, acc = [0], 0
        for ax in sig:
            acc |= 4 >> ax
            v.append(acc)
        tets.append(v)
    return np.asarray(tets, dtype=np.int32)


def _level(coords, elems, edges, elem_edges, parents, vmask, emask, elmask, fdict, bricks=None, epb=0) -> dict:
    return dict(coords=coords, elems=elems, edges=edges, elem_edges=elem_edges, parents=parents,
                subset_vertices=vmask, subset_edges=emask, subset_elems=elmask, subset_faces=fdict,
                bricks=bricks, elems_per_brick=epb)


def channel_3d(lo=(-10.0, -3.0, -3.0), hi=(10.0, 3.0, 3.0), obs_lo=(-0.5, -0.5, -0.5),
               obs_hi=(0.5, 0.5, 0.5), n_side=(4, 2, 2)) -> dict:
    """Kuhn-tetrahedralized box [-10,10]x[-3,3]^2 with a unit-cube obstacle
    hole, brick metadata attached (the port's geomgen.channel_3d)."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    obs_lo, obs_hi = np.asarray(obs_lo, float), np.asarray(obs_hi, float)
    axes = [_axis(lo[k], hi[k], obs_lo[k], obs_hi[k], n_side[k]) for k in range(3)]
    n = [len(a) - 1 for a in axes]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    sy, sz = (n[1] + 1) * (n[2] + 1), n[2] + 1
    corner_off = np.array([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], dtype=np.int64)
    kuhn = _path_kuhn_tets()
    tets, bricks = [], []
    for i in range(n[0]):
        for j in range(n[1]):
            for k in range(n[2]):
                base = i * sy + j * sz + k
                cc = 0.5 * (coords[base] + coords[base + sy + sz + 1])
                if np.all((cc > obs_lo - EPS) & (cc < obs_hi + EPS)):
                    continue
                cid = [base + o[0] * sy + o[1] * sz + o[2] for o in corner_off]
                bricks.append(cid)
                for t in kuhn:
                    tets.append([cid[t[0]], cid[t[1]], cid[t[2]], cid[t[3]]])
    elems = np.asarray(tets, dtype=np.int32)
    used = np.unique(elems)
    remap = -np.ones(len(coords), dtype=np.int64)
    remap[used] = np.arange(len(used))
    coords = coords[used]
    elems = remap[elems].astype(np.int32)
    edges, elem_edges = edges_and_elem_edges(elems, len(coords))
    vmask, emask, elmask, fdict = _tag_subsets(coords, elems, edges, lo, hi, obs_lo, obs_hi)
    V = len(coords)
    parents = np.stack([np.arange(V)] * 2, axis=1).astype(np.int32)
    return _level(coords, elems, edges, elem_edges, parents, vmask, emask, elmask, fdict,
                  bricks=remap[np.asarray(bricks, dtype=np.int64)].astype(np.int32), epb=6)


# ---------------------------------------------------------------------------
# uniform red refinement (Bey's rule), children not re-oriented
# ---------------------------------------------------------------------------

def refine(lvl: dict) -> dict:
    coords0, edges0 = lvl["coords"], lvl["edges"]
    V, Ne = len(coords0), len(edges0)
    coords = np.concatenate([coords0, coords0[edges0].mean(axis=1)], axis=0)
    parents = np.concatenate([np.stack([np.arange(V)] * 2, axis=1), edges0], axis=0).astype(np.int32)

    ee = lvl["elem_edges"] + V
    el = lvl["elems"]
    x0, x1, x2, x3 = el[:, 0], el[:, 1], el[:, 2], el[:, 3]
    m01, m02, m03, m12, m13, m23 = (ee[:, i] for i in range(6))
    children = np.stack([
        np.stack([x0, m01, m02, m03], 1),
        np.stack([m01, x1, m12, m13], 1),
        np.stack([m02, m12, x2, m23], 1),
        np.stack([m03, m13, m23, x3], 1),
        np.stack([m01, m02, m03, m13], 1),
        np.stack([m01, m02, m12, m13], 1),
        np.stack([m02, m03, m13, m23], 1),
        np.stack([m02, m12, m13, m23], 1),
    ], axis=1)  # (E, 8, 4)
    del ee, x0, x1, x2, x3, m01, m02, m03, m12, m13, m23
    elems = children.reshape(-1, 4).astype(np.int32)
    del children
    edges, elem_edges = edges_and_elem_edges(elems, len(coords))

    lo, hi = edges[:, 0], edges[:, 1]
    child_of = np.full(len(edges), -1, dtype=np.int64)
    cand = (lo < V) & (hi >= V)
    pe = edges0[np.clip(hi - V, 0, Ne - 1)]
    is_child = cand & ((pe[:, 0] == lo) | (pe[:, 1] == lo))
    child_of[is_child] = hi[is_child] - V
    del pe, cand, is_child
    mask_c = child_of >= 0

    sub_v, sub_e, sub_el, sub_f = {}, {}, {}, {}
    for name in lvl["subset_vertices"]:
        mv = np.zeros(len(coords), dtype=bool)
        mv[:V] = lvl["subset_vertices"][name]
        mv[V:] = lvl["subset_edges"][name]
        sub_v[name] = mv
        me = np.zeros(len(edges), dtype=bool)
        me[mask_c] = lvl["subset_edges"][name][child_of[mask_c]]
        sub_e[name] = me
        sub_el[name] = np.repeat(lvl["subset_elems"][name], 8)

    for name, faces in lvl["subset_faces"].items():
        if len(faces) == 0:
            sub_f[name] = np.zeros((0, 3), dtype=np.int32)
            continue
        fe = edge_lookup(edges0, np.sort(faces[:, TRI_EDGES], axis=-1)) + V
        fa, fb, fc = faces[:, 0], faces[:, 1], faces[:, 2]
        mab, mac, mbc = fe[:, 0], fe[:, 1], fe[:, 2]
        kids = np.stack([
            np.stack([fa, mab, mac], 1),
            np.stack([mab, fb, mbc], 1),
            np.stack([mac, mbc, fc], 1),
            np.stack([mab, mbc, mac], 1),
        ], axis=1).reshape(-1, 3)
        sub_f[name] = kids.astype(np.int32)
        inner = np.stack([fe[:, [0, 1]], fe[:, [0, 2]], fe[:, [1, 2]]], 1).reshape(-1, 2)
        sub_e[name][edge_lookup(edges, inner)] = True

    return _level(coords, elems, edges, elem_edges, parents, sub_v, sub_e, sub_el, sub_f)


def build_levels(refs: int) -> list:
    levels = [channel_3d()]
    for _ in range(refs):
        levels.append(refine(levels[-1]))
    return levels


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

_DICTS = ("subset_vertices", "subset_edges", "subset_elems", "subset_faces")


def _flatten(lvl: dict) -> dict:
    out = {}
    for key, val in lvl.items():
        if key in _DICTS:
            for name, arr in val.items():
                out[f"{key}.{name}"] = arr
        elif val is not None:
            out[key] = np.asarray(val)
    return out


def _unflatten(arrays) -> dict:
    lvl = {key: {} for key in _DICTS}
    lvl["bricks"] = None
    for key in arrays.files:
        head, _, name = key.partition(".")
        if head in _DICTS:
            lvl[head][name] = arrays[key]
        else:
            lvl[key] = arrays[key]
    lvl["elems_per_brick"] = int(lvl["elems_per_brick"])
    return lvl


def cache_path(refs: int) -> pathlib.Path:
    return CACHE_DIR / f"{source_hash()[:16]}-r{refs}"


def load_levels(refs: int, log=print) -> tuple[list, dict]:
    """The refs+1 levels of the channel, from the cache or refined and
    cached.  Returns (levels, info) with info's seconds, whether the cache
    was hit, and its size in bytes."""
    path = cache_path(refs)
    t0 = time.perf_counter()
    files = [path / f"level{l}.npz" for l in range(refs + 1)]
    if all(f.exists() for f in files):
        levels = []
        for f in files:
            with np.load(f) as z:
                levels.append(_unflatten(z))
        hit = True
    else:
        levels = build_levels(refs)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.mkdir(exist_ok=True)
        for l, lvl in enumerate(levels):
            np.savez(tmp / f"level{l}.npz", **_flatten(lvl))
        try:
            os.rename(tmp, path)
        except OSError:  # another run cached the same levels first
            for f in tmp.iterdir():
                f.unlink()
            tmp.rmdir()
        hit = False
    size = sum(f.stat().st_size for f in files if f.exists())
    info = dict(seconds=time.perf_counter() - t0, cache_hit=hit, cache_bytes=size)
    log(f"mesh refs={refs}: {'cache hit' if hit else 'refined and cached'} in {info['seconds']:.2f} s, "
        f"cache {size} bytes")
    return levels, info


def dirichlet_mask(lvl: dict, names) -> np.ndarray:
    m = np.zeros(len(lvl["coords"]), dtype=bool)
    for name in names:
        m |= lvl["subset_vertices"][name]
    return m
