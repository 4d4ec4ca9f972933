"""Built-in geometry generator: channel-with-obstacle meshes.

Produces the same *geometry class* as the reference's grid fixtures
(``grids/refined.ugx``: a [-7,7]x[-3,3] channel with a unit-square obstacle
at the origin; ``grids/box_3D_elongated.ugx``: a [-10,10]x[-3,3]^2 box with a
unit-cube obstacle), with the same five boundary subsets
``outer, wall, obstacle_surface, inlet, outlet``.  Users with UG4 grids can
instead load any ``.ugx`` through core.ugx.

The generator builds a structured simplicial coarse mesh (quads split into 2
triangles in 2D; hexes split into 6 Kuhn tetrahedra in 3D - uniform Kuhn
splitting is conforming across shared faces), removes the cells inside the
obstacle, and tags subsets geometrically.
"""
from __future__ import annotations

import numpy as np

from .mesh import MeshLevel, TET_EDGES, TRI_EDGES, _edge_lookup, _edge_table, _orient_positive

EPS = 1e-9


def _tag_subsets(
    coords: np.ndarray,
    elems: np.ndarray,
    edges: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    obs_lo: np.ndarray,
    obs_hi: np.ndarray,
):
    """Geometric subset predicates; returns the five subset dicts."""
    dim = coords.shape[1]

    def on_plane(pts, axis, value):
        return np.abs(pts[:, axis] - value) < EPS

    def on_obstacle(pts):
        # on the surface of the obstacle box: inside the closed box and on
        # at least one of its faces
        inside = np.all(
            (pts >= obs_lo - EPS) & (pts <= obs_hi + EPS), axis=1
        )
        on_face = np.zeros(len(pts), dtype=bool)
        for ax in range(dim):
            on_face |= on_plane(pts, ax, obs_lo[ax]) | on_plane(pts, ax, obs_hi[ax])
        return inside & on_face

    vmask = {}
    vmask["inlet"] = on_plane(coords, 0, lo[0])
    vmask["outlet"] = on_plane(coords, 0, hi[0])
    wall = np.zeros(len(coords), dtype=bool)
    for ax in range(1, dim):
        wall |= on_plane(coords, ax, lo[ax]) | on_plane(coords, ax, hi[ax])
    # corners shared with inlet/outlet count as wall too (reference grids tag
    # channel side boundaries as wall); keep inlet/outlet owning their planes
    vmask["wall"] = wall & ~vmask["inlet"] & ~vmask["outlet"]
    vmask["obstacle_surface"] = on_obstacle(coords)
    vmask["outer"] = np.ones(len(coords), dtype=bool)

    # edge subsets: midpoint satisfies the predicate and both endpoints do
    emid = coords[edges].mean(axis=1)
    emask = {}
    emask["obstacle_surface"] = on_obstacle(emid) & vmask["obstacle_surface"][edges].all(axis=1)
    emask["inlet"] = on_plane(emid, 0, lo[0]) & vmask["inlet"][edges].all(axis=1)
    emask["outlet"] = on_plane(emid, 0, hi[0]) & vmask["outlet"][edges].all(axis=1)
    wall_e = np.zeros(len(edges), dtype=bool)
    for ax in range(1, dim):
        wall_e |= on_plane(emid, ax, lo[ax]) | on_plane(emid, ax, hi[ax])
    emask["wall"] = wall_e & ~emask["inlet"] & ~emask["outlet"]
    emask["outer"] = np.ones(len(edges), dtype=bool)

    elmask = {name: np.zeros(len(elems), dtype=bool) for name in vmask}
    elmask["outer"][:] = True

    # 3D boundary faces per subset
    fdict = {name: np.zeros((0, 3), dtype=np.int32) for name in vmask}
    if dim == 3:
        # collect boundary triangles = faces appearing exactly once
        faces = np.concatenate(
            [elems[:, [0, 1, 2]], elems[:, [0, 1, 3]], elems[:, [0, 2, 3]], elems[:, [1, 2, 3]]]
        )
        key = np.sort(faces, axis=1)
        uniq, idx, cnt = np.unique(key, axis=0, return_index=True, return_counts=True)
        bfaces = faces[idx[cnt == 1]]
        fmid = coords[bfaces].mean(axis=1)
        fdict["inlet"] = bfaces[on_plane(fmid, 0, lo[0])].astype(np.int32)
        fdict["outlet"] = bfaces[on_plane(fmid, 0, hi[0])].astype(np.int32)
        wf = np.zeros(len(bfaces), dtype=bool)
        for ax in range(1, 3):
            wf |= on_plane(fmid, ax, lo[ax]) | on_plane(fmid, ax, hi[ax])
        fdict["wall"] = bfaces[wf].astype(np.int32)
        fdict["obstacle_surface"] = bfaces[on_obstacle(fmid)].astype(np.int32)
    return vmask, emask, elmask, fdict


def _build_level(
    coords, elems, lo, hi, obs_lo, obs_hi, reorient=True, bricks=None, epb=0
) -> MeshLevel:
    dim = coords.shape[1]
    elems = elems.astype(np.int32)
    if reorient:
        # brick meshes must NOT be reoriented: the canonical (path-ordered
        # Kuhn / fixed-diagonal) vertex order is what keeps refinement
        # translation-invariant for the patch-stencil fast path.
        elems = _orient_positive(coords, elems)
    loc = TET_EDGES if dim == 3 else TRI_EDGES
    edges = _edge_table(elems[:, loc].reshape(-1, 2))
    elem_edges = _edge_lookup(edges, np.sort(elems[:, loc], axis=-1))
    vmask, emask, elmask, fdict = _tag_subsets(coords, elems, edges, lo, hi, obs_lo, obs_hi)
    V = len(coords)
    parents = np.stack([np.arange(V)] * 2, axis=1).astype(np.int32)
    return MeshLevel(
        dim, coords, elems, edges, elem_edges, parents, vmask, emask, elmask,
        fdict, bricks=bricks, elems_per_brick=epb,
    )


def _axis(lo, hi, obs_lo, obs_hi, n_side):
    """Grid lines: n_side segments on each side of the obstacle interval plus
    the obstacle faces themselves, so cells conform to the obstacle box."""
    return np.concatenate(
        [np.linspace(lo, obs_lo, n_side + 1), np.linspace(obs_hi, hi, n_side + 1)]
    )


def channel_2d(
    lo=(-7.0, -3.0),
    hi=(7.0, 3.0),
    obs_lo=(-0.5, -0.5),
    obs_hi=(0.5, 0.5),
    n_side=(6, 2),
    diag="alt",
) -> MeshLevel:
    """Structured triangulated channel with a square obstacle hole.

    diag="alt": union-jack-ish alternating diagonal (symmetric-ish mesh).
    diag="fixed": every quad split along the SAME diagonal a-c with canonical
    vertex order [a,b,c]/[a,c,d] and brick metadata attached - required for
    the patch-stencil fast path (core.patches)."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    obs_lo, obs_hi = np.asarray(obs_lo, float), np.asarray(obs_hi, float)
    xs = _axis(lo[0], hi[0], obs_lo[0], obs_hi[0], n_side[0])
    ys = _axis(lo[1], hi[1], obs_lo[1], obs_hi[1], n_side[1])
    nx, ny = len(xs) - 1, len(ys) - 1
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    tris, bricks = [], []
    for i in range(nx):
        for j in range(ny):
            cc = coords[[vid(i, j), vid(i + 1, j + 1)]].mean(axis=0)
            if np.all((cc > obs_lo - EPS) & (cc < obs_hi + EPS)):
                continue  # hole
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            if diag == "fixed":
                tris += [[a, b, c], [a, c, d]]
                # corner order (x-major bit order): (0,0),(0,1),(1,0),(1,1)
                bricks.append([a, d, b, c])
            elif (i + j) % 2 == 0:
                tris += [[a, b, c], [a, c, d]]
            else:
                tris += [[a, b, d], [b, c, d]]
    elems = np.asarray(tris, dtype=np.int32)
    used = np.unique(elems)
    remap = -np.ones(len(coords), dtype=np.int64)
    remap[used] = np.arange(len(used))
    kw = {}
    if diag == "fixed":
        kw = dict(
            reorient=False,
            bricks=remap[np.asarray(bricks, dtype=np.int64)].astype(np.int32),
            epb=2,
        )
    return _build_level(
        coords[used], remap[elems].astype(np.int32), lo, hi, obs_lo, obs_hi, **kw
    )


def _path_kuhn_tets() -> np.ndarray:
    """Kuhn decomposition of the unit cube into 6 tets along the main
    diagonal, in canonical MONOTONE-PATH vertex order: for each axis
    permutation sigma, v0=000, v_i = v_{i-1} + e_{sigma(i)}.  This ordering
    makes Bey red refinement exactly self-similar (6 translation classes,
    15-point lattice stencil at every level - verified in tests), which the
    patch-stencil fast path depends on.  Half the tets have negative detJ;
    all assembly uses |detJ| (ops.geometry)."""
    import itertools

    tets = []
    for sig in itertools.permutations(range(3)):
        v, acc = [0], 0
        for ax in sig:
            acc |= 4 >> ax  # e_x=0b100, e_y=0b010, e_z=0b001
            v.append(acc)
        tets.append(v)
    return np.asarray(tets, dtype=np.int32)


KUHN_TETS = _path_kuhn_tets()


def channel_3d(
    lo=(-10.0, -3.0, -3.0),
    hi=(10.0, 3.0, 3.0),
    obs_lo=(-0.5, -0.5, -0.5),
    obs_hi=(0.5, 0.5, 0.5),
    n_side=(4, 2, 2),
) -> MeshLevel:
    """Structured Kuhn-tetrahedralized box with a cube obstacle hole."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    obs_lo, obs_hi = np.asarray(obs_lo, float), np.asarray(obs_hi, float)
    axes = [_axis(lo[k], hi[k], obs_lo[k], obs_hi[k], n_side[k]) for k in range(3)]
    n = [len(a) - 1 for a in axes]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    sy, sz = (n[1] + 1) * (n[2] + 1), n[2] + 1

    def vid(i, j, k):
        return i * sy + j * sz + k

    tets, bricks = [], []
    corner_off = np.array(
        [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], dtype=np.int64
    )
    for i in range(n[0]):
        for j in range(n[1]):
            for k in range(n[2]):
                cc = 0.5 * (coords[vid(i, j, k)] + coords[vid(i + 1, j + 1, k + 1)])
                if np.all((cc > obs_lo - EPS) & (cc < obs_hi + EPS)):
                    continue
                cid = [
                    vid(i + o[0], j + o[1], k + o[2]) for o in corner_off
                ]
                bricks.append(cid)
                for t in KUHN_TETS:
                    tets.append([cid[t[0]], cid[t[1]], cid[t[2]], cid[t[3]]])
    elems = np.asarray(tets, dtype=np.int32)
    used = np.unique(elems)
    remap = -np.ones(len(coords), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return _build_level(
        coords[used],
        remap[elems].astype(np.int32),
        lo,
        hi,
        obs_lo,
        obs_hi,
        reorient=False,
        bricks=remap[np.asarray(bricks, dtype=np.int64)].astype(np.int32),
        epb=6,
    )
