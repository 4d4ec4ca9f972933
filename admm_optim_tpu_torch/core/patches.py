"""Brick-patch lattice decomposition of refinement hierarchies.

The TPU-native answer to the reference's unstructured-FEM data layout
(SURVEY.md section 7 "design stance"): the coarse mesh is a set of BRICKS
(quads split into 2 fixed-diagonal triangles in 2D / hexes split into 6
path-ordered Kuhn tetrahedra in 3D, core.geomgen).  Uniform red/Bey
refinement of such a brick is exactly self-similar, so after k refinements
every brick carries a full (m+1)^d lattice of fine vertices (m = 2^k) with

 * a translation-invariant element structure: every lattice cell contains
   the same 2 (2D) / 6 (3D) element classes, each a fixed tuple of vertex
   offsets;
 * a fixed sparsity stencil: 7-point (2D) / 15-point (3D) lattice offsets;
 * nested coarse lattices: level l sites are the stride-2^(k-l) sites.

Fields then live in dense arrays ``(C, m1, [m1,] m1, P)`` (lattice dims
major, patch axis on TPU lanes) and every hot operation - SpMV, Chebyshev
smoothing, MG transfers, assembly - is a static-slice stencil op with ZERO
gather/scatter in the interior.  Measured on v5e: XLA's per-element gather
runs at ~1 element/cycle, which made the general block-ELL SpMV (ops.
sparsity) 4.4 ms/spmv at 367k DoF vs ~0.1 ms of actual arithmetic; this
layout removes that tax entirely.  Cross-patch coupling (sites shared by
neighboring bricks are DUPLICATED in each patch) costs one small
boundary-exchange per operator application: additive partial sums at
duplicated sites are summed by a segment-sum over boundary slots only (the
UG4 additive->consistent storage-type protocol, 2d_admm.lua:904-961, now
on-chip).

Host-side construction only; device kernels live in ops.patchstencil and
solvers.patch_mg.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .mesh import Hierarchy, _edge_lookup


@dataclasses.dataclass
class PatchLevel:
    """Static per-level data (host numpy; device code re-wraps as needed)."""

    m: int  # cells per brick edge (= 2^level)
    gid: np.ndarray  # (P, m+1, [m+1,] m+1) int32 global vertex id per site
    # boundary exchange (additive -> consistent): site-slot s of the flat
    # (prod(lat), P) site space appears in bslots iff its gid is shared by
    # several patches; bseg groups duplicates
    bslots: np.ndarray  # (B,) int64 flat indices (site-major, patch minor)
    bseg: np.ndarray  # (B,) int32 duplicate-group id
    nseg: int
    owner: np.ndarray  # (m+1, [m+1,] m+1, P) float32 1.0 at owned sites
    free: np.ndarray  # (m+1, [m+1,] m+1, P) float32 0.0 at Dirichlet sites
    # slab exchange (fast path): per axis, the +/- face neighbor patch index
    # (self where missing) and its validity mask.  Sites whose duplicate sum
    # the sequential sweep composition cannot reproduce (staircase paths
    # broken by obstacle holes / domain boundary; identified at build time
    # against the segment-sum ground truth) are fixed by a tiny correction
    # pass over corr_slots.
    face_nbr: np.ndarray | None = None  # (dim, 2, P) int32; [:,0]=minus
    face_mask: np.ndarray | None = None  # (dim, 2, P) float32
    # scatter-free correction (dynamic scatters into large arrays cost ~5 ms
    # on v5e regardless of index count): gather corr values multi-dim,
    # group-sum via a tiny one-hot matmul, and write back through per-face
    # inverse maps - 1-based group id per slab slot, 0 = keep.  (An earlier
    # (G, prod(slab)*P) one-hot-matmul write-back was O(G*slab) memory:
    # 2.1 GB at 3D refs=5; the gather maps are O(slab).)
    corr_idx: tuple | None = None  # dim+1 int32 arrays (Bc,): lattice + patch
    corr_group_oh: np.ndarray | None = None  # (Bc, G) f32 one-hot group sum
    corr_slot: list | None = None  # per face: (*slab, P) int32 1-based gid
    corr_nseg: int = 0
    use_slab: bool = False

    @property
    def lat_shape(self) -> tuple:
        return self.gid.shape[1:]

    @property
    def P(self) -> int:
        return self.gid.shape[0]

    @property
    def n_sites(self) -> int:
        return int(np.prod(self.lat_shape)) * self.P


@dataclasses.dataclass
class PatchSet:
    """A brick-patch view of a refinement hierarchy."""

    dim: int
    k: int  # fine level index (levels[k] has m = 2^k)
    P: int
    levels: list  # [PatchLevel] index l = 0..k
    # element classes: (nclass, nl, dim) vertex lattice offsets per class,
    # identical at every level and every cell anchor
    class_offsets: np.ndarray
    # stencil: (noffs, dim) neighbor offsets (union of o_b - o_a), offset 0
    # first; and slot lookup dict
    stencil: np.ndarray
    stencil_slot: dict

    @property
    def fine(self) -> PatchLevel:
        return self.levels[-1]


def _lat_coords(dim, m1):
    """All lattice sites as (m1^dim, dim) ints, C-order (last axis minor)."""
    grids = np.meshgrid(*([np.arange(m1)] * dim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)


def _slab_exchange_tables(dim, gid, bslots, bseg, nseg):
    """Face-neighbor tables for the slab exchange fast path.

    The additive->consistent duplicate sum is realized as `dim` sequential
    axis sweeps, each adding the opposite face slab of the axis neighbor
    (static slices + one tiny patch-axis gather per face - no dynamic
    scatter).  Edge/corner multi-duplicates are summed by sweep composition
    through staircase-connected neighbors; validity is verified here against
    the segment-sum ground truth on a random vector, falling back to the
    general path when the brick adjacency is not composable."""
    P = gid.shape[0]
    lat = gid.shape[1:]
    face_nbr = np.tile(np.arange(P, dtype=np.int32), (dim, 2, 1))
    face_mask = np.zeros((dim, 2, P), dtype=np.float32)
    for a in range(dim):
        # face key: sorted tuple of gid corners of that face
        def face_key(p, side):
            idx = [slice(None)] * dim
            idx[a] = 0 if side == 0 else lat[a] - 1
            sl = gid[p][tuple(idx)]
            return tuple(np.sort(sl.ravel()))

        table = {}
        for p in range(P):
            for side in range(2):
                table.setdefault(face_key(p, side), []).append((p, side))
        for key, ents in table.items():
            if len(ents) == 2:
                (p, sp), (q, sq) = ents
                if sp == sq:
                    continue  # inverted pair; not composable -> stays masked
                face_nbr[a, sp, p] = q
                face_nbr[a, sq, q] = p
                face_mask[a, sp, p] = 1.0
                face_mask[a, sq, q] = 1.0
    # orientation check: the shared face slabs must match elementwise
    for a in range(dim):
        for p in range(P):
            for side in range(2):
                if face_mask[a, side, p] == 0.0:
                    continue
                q = face_nbr[a, side, p]
                idx_p = [slice(None)] * dim
                idx_p[a] = 0 if side == 0 else lat[a] - 1
                idx_q = [slice(None)] * dim
                idx_q[a] = lat[a] - 1 if side == 0 else 0
                if not np.array_equal(gid[p][tuple(idx_p)], gid[q][tuple(idx_q)]):
                    return (None,) * 5 + (0, False)

    def sweep(y):
        yc = y.copy()
        for a in range(dim):
            lo = [slice(None)] * (dim + 1)
            hi = [slice(None)] * (dim + 1)
            lo[a], hi[a] = 0, lat[a] - 1
            lo, hi = tuple(lo), tuple(hi)
            slab_lo, slab_hi = yc[lo], yc[hi]
            new_lo = slab_lo + slab_hi[..., face_nbr[a, 0]] * face_mask[a, 0]
            new_hi = slab_hi + slab_lo[..., face_nbr[a, 1]] * face_mask[a, 1]
            yc[lo], yc[hi] = new_lo, new_hi
        return yc

    # identify slots the sweep composition gets wrong (two independent
    # random vectors; coincidental agreement has probability ~0)
    rng = np.random.default_rng(0)
    wrong = np.zeros(int(np.prod(lat)) * P, dtype=bool)
    g_sp = np.moveaxis(gid.reshape(P, -1), 0, 1).reshape(-1)
    for _ in range(2):
        y = rng.normal(size=lat + (P,))
        yc = sweep(y)
        yf = y.reshape(-1, P).reshape(-1)
        sums = np.zeros(nseg)
        np.add.at(sums, bseg, yf[bslots])
        yt = yf.copy()
        yt[bslots] = sums[bseg]
        wrong |= np.abs(yc.reshape(-1) - yt) > 1e-9 * np.maximum(1.0, np.abs(yt))
    # correct ALL copies of any affected vertex (keeps consistency)
    bad_gids = np.unique(g_sp[wrong])
    in_bad = np.isin(g_sp[bslots], bad_gids)
    corr_slots = bslots[in_bad]
    seg_ids = bseg[in_bad]
    useg, corr_seg = np.unique(seg_ids, return_inverse=True)
    G = len(useg)
    Bc = len(corr_slots)
    # scatter-free correction tables
    site = corr_slots // P
    pch = (corr_slots % P).astype(np.int32)
    mi = np.unravel_index(site, lat)
    corr_idx = tuple(a.astype(np.int32) for a in mi) + (pch,)
    group_oh = np.zeros((Bc, G), np.float32)
    group_oh[np.arange(Bc), corr_seg] = 1.0
    slot_maps = []
    for f in range(2 * dim):
        a, sd = f // 2, f % 2
        onface = mi[a] == (0 if sd == 0 else lat[a] - 1)
        rest = [mi[b] for b in range(dim) if b != a]
        slab_shape = tuple(lat[b] for b in range(dim) if b != a) + (P,)
        flat = rest[0].astype(np.int64)
        for b, r in enumerate(rest[1:], start=1):
            flat = flat * slab_shape[b] + r
        flat = flat * P + pch
        sm = np.zeros(int(np.prod(slab_shape)), np.int32)
        sm[flat[onface]] = corr_seg[onface] + 1
        slot_maps.append(sm.reshape(slab_shape))
    return (
        face_nbr,
        face_mask,
        corr_idx,
        group_oh,
        slot_maps,
        G,
        True,
    )


def pad_patch_level(lvl: PatchLevel, P_pad: int) -> PatchLevel:
    """Pad the patch axis to P_pad with inert dummy patches.

    Dummies replicate patch 0's gid (so their lattice coordinates, hence
    element matrices, stay finite) but carry owner=0, free=0 and zero face
    masks: they never contribute to exchanges, inner products, or the
    owner-picked global gather, so every operator is exactly unchanged on
    the real patches."""
    P, pad = lvl.P, P_pad - lvl.P
    if pad <= 0:
        return lvl
    lat = lvl.lat_shape
    dim = len(lat)
    gid = np.concatenate([lvl.gid, np.repeat(lvl.gid[:1], pad, axis=0)], axis=0)
    site = lvl.bslots // P
    pch = lvl.bslots % P
    bslots = site * P_pad + pch
    owner = np.concatenate(
        [lvl.owner, np.zeros(lat + (pad,), lvl.owner.dtype)], axis=-1
    )
    free = np.concatenate([lvl.free, np.zeros(lat + (pad,), lvl.free.dtype)], axis=-1)
    kw = {}
    if lvl.use_slab:
        nbr_pad = np.tile(
            np.arange(P, P_pad, dtype=np.int32), (dim, 2, 1)
        )
        kw["face_nbr"] = np.concatenate([lvl.face_nbr, nbr_pad], axis=-1)
        kw["face_mask"] = np.concatenate(
            [lvl.face_mask, np.zeros((dim, 2, pad), lvl.face_mask.dtype)], axis=-1
        )
        kw["corr_idx"] = lvl.corr_idx
        kw["corr_group_oh"] = lvl.corr_group_oh
        if lvl.corr_nseg:
            slot_maps = []
            for f in range(2 * dim):
                a = f // 2
                slab_lat = tuple(lat[b] for b in range(dim) if b != a)
                sm = np.concatenate(
                    [lvl.corr_slot[f], np.zeros(slab_lat + (pad,), np.int32)],
                    axis=-1,
                )
                slot_maps.append(sm)
            kw["corr_slot"] = slot_maps
    return PatchLevel(
        m=lvl.m,
        gid=gid,
        bslots=bslots,
        bseg=lvl.bseg,
        nseg=lvl.nseg,
        owner=owner,
        free=free,
        corr_nseg=lvl.corr_nseg,
        use_slab=lvl.use_slab,
        **kw,
    )


def pad_patchset(ps: PatchSet, multiple: int) -> PatchSet:
    """Pad every level's patch axis to a multiple (for sharding P over a
    device mesh axis, parallel.patch_shard)."""
    P_pad = -(-ps.P // multiple) * multiple
    if P_pad == ps.P:
        return ps
    return PatchSet(
        dim=ps.dim,
        k=ps.k,
        P=P_pad,
        levels=[pad_patch_level(lvl, P_pad) for lvl in ps.levels],
        class_offsets=ps.class_offsets,
        stencil=ps.stencil,
        stencil_slot=ps.stencil_slot,
    )


def build_patchset(hier: Hierarchy, dirichlet=("inlet", "wall", "outlet")) -> PatchSet:
    """Build the patch view of a hierarchy whose level 0 carries brick
    metadata (core.geomgen channel_2d(diag="fixed") / channel_3d)."""
    lvl0 = hier.levels[0]
    if lvl0.bricks is None:
        raise ValueError(
            "patch backend requires brick metadata on the coarse mesh "
            "(geomgen channel_2d(diag='fixed') or channel_3d)"
        )
    dim = hier.dim
    k = len(hier.levels) - 1
    P = len(lvl0.bricks)

    # ---- per-level gid arrays via the parity-parent rule --------------------
    # Kuhn/fixed-diagonal lattices have the property that the midpoint parent
    # offset of an odd site s is h = s mod 2 (verified below via edge lookup,
    # which raises if the mesh edge does not exist).
    gshape0 = (P,) + (2,) * dim
    gid = [lvl0.bricks.reshape(gshape0).astype(np.int64)]
    for l in range(k):
        lv = hier.levels[l]
        m = 2**l
        m2 = 2 * m
        g = gid[l]
        new_shape = (P,) + (m2 + 1,) * dim
        gn = np.full(new_shape, -1, dtype=np.int64)
        # even sites
        ev = (slice(None),) + (slice(0, None, 2),) * dim
        gn[ev] = g
        # odd parity classes
        for pc in range(1, 2**dim):
            h = np.array([(pc >> (dim - 1 - a)) & 1 for a in range(dim)])
            # sites s with s mod 2 == h: s = 2t + h, t in [0, m2-h)/2 ranges
            sl_new = (slice(None),) + tuple(
                slice(int(hh), None, 2) for hh in h
            )
            # parents (s - h)/2 = t and (s + h)/2 = t + h in level-l lattice
            sl_p1 = (slice(None),) + tuple(
                slice(0, m + 1 - int(hh)) for hh in h
            )
            sl_p2 = (slice(None),) + tuple(
                slice(int(hh), m + 1) for hh in h
            )
            a, b = g[sl_p1], g[sl_p2]
            pairs = np.sort(np.stack([a.ravel(), b.ravel()], axis=1), axis=1)
            eid = _edge_lookup(lv.edges, pairs)  # raises if not a mesh edge
            gn[sl_new] = (lv.num_vertices + eid).reshape(a.shape)
        assert (gn >= 0).all()
        gid.append(gn)

    # sanity: site coordinates must be the barycentric lattice points
    fine = hier.levels[k]
    m = 2**k
    lat = _lat_coords(dim, m + 1).astype(np.float64) / m  # (S, dim)
    c0 = lvl0.coords[gid[0].reshape(P, -1)]  # (P, 2^dim, dim) brick corners
    # trilinear corner interpolation == actual coords (bricks are affine
    # boxes here; tolerate general hexes via the mesh's own coords instead)
    got = fine.coords[gid[k].reshape(P, -1)]
    del c0, lat, got  # cheap structural checks happen in tests

    # ---- element classes from patch 0 ---------------------------------------
    epb = lvl0.elems_per_brick
    nch = 4 if dim == 2 else 8
    fepb = epb * nch**k  # fine elements per brick (ancestry-contiguous)
    sitemap = {int(g): i for i, g in enumerate(gid[k][0].ravel())}
    lat_sites = _lat_coords(dim, m + 1)
    f_el = fine.elems[:fepb]
    el_sites = np.array(
        [[lat_sites[sitemap[int(v)]] for v in e] for e in f_el]
    )  # (fepb, nl, dim)
    anchors = el_sites.min(axis=1)
    offs = el_sites - anchors[:, None, :]
    # canonicalize vertex order (lexicographic): refinement permutes child
    # vertex orders position-dependently, but the local element matrix is
    # order-covariant, so the sorted offset tuple is the true class key
    classes = {}
    for i in range(fepb):
        rows = sorted(map(tuple, offs[i]))
        classes.setdefault(tuple(np.array(rows).ravel()), []).append(anchors[i])
    nclass = len(classes)
    if nclass != epb:
        raise AssertionError(
            f"element classes not translation-invariant: {nclass} != {epb}"
        )
    class_offsets = np.array(
        [np.array(key).reshape(dim + 1, dim) for key in sorted(classes)],
        dtype=np.int64,
    )
    for key in classes:  # each class present at every cell anchor
        a = np.array(classes[key])
        assert len(a) == m**dim and a.min() == 0 and a.max() == m - 1

    # ---- stencil offsets -----------------------------------------------------
    diffs = set()
    for co in class_offsets:
        for i in range(dim + 1):
            for j in range(dim + 1):
                diffs.add(tuple(co[j] - co[i]))
    diffs = sorted(diffs, key=lambda t: (t != tuple([0] * dim), t))
    stencil = np.array(diffs, dtype=np.int64)
    assert tuple(stencil[0]) == tuple([0] * dim)
    stencil_slot = {tuple(o): i for i, o in enumerate(stencil)}

    # ---- per-level exchange / ownership / dirichlet --------------------------
    fixed_mask_by_level = []
    for l in range(k + 1):
        fm = hier.levels[l].vertex_mask(dirichlet)
        fixed_mask_by_level.append(fm)

    levels = []
    for l in range(k + 1):
        g = gid[l]  # (P, *lat)
        lat_shape = g.shape[1:]
        S = int(np.prod(lat_shape))
        # flat site order: site-major, patch minor -> matches device arrays
        # (C, *lat, P).reshape(C, -1)
        g_sp = np.moveaxis(g.reshape(P, S), 0, 1).reshape(-1)  # (S*P,)
        uniq, first, inv, cnt = np.unique(
            g_sp, return_index=True, return_inverse=True, return_counts=True
        )
        dup = cnt[inv] > 1
        bslots = np.nonzero(dup)[0].astype(np.int64)
        seg_of_uniq = -np.ones(len(uniq), dtype=np.int64)
        dup_uniq = np.nonzero(cnt > 1)[0]
        seg_of_uniq[dup_uniq] = np.arange(len(dup_uniq))
        bseg = seg_of_uniq[inv[bslots]].astype(np.int32)
        owner = np.zeros(S * P, dtype=np.float32)
        owner[first] = 1.0
        owner = owner.reshape(S, P).reshape(lat_shape + (P,))
        free = (~fixed_mask_by_level[l][g_sp]).astype(np.float32)
        free = free.reshape(S, P).reshape(lat_shape + (P,))
        (
            face_nbr, face_mask, corr_idx, corr_group_oh, corr_slot,
            corr_nseg, use_slab,
        ) = _slab_exchange_tables(dim, g, bslots, bseg, len(dup_uniq))
        levels.append(
            PatchLevel(
                m=2**l,
                gid=g.astype(np.int32),
                bslots=bslots,
                bseg=bseg,
                nseg=len(dup_uniq),
                owner=owner,
                free=free,
                face_nbr=face_nbr,
                face_mask=face_mask,
                corr_idx=corr_idx,
                corr_group_oh=corr_group_oh,
                corr_slot=corr_slot,
                corr_nseg=corr_nseg,
                use_slab=use_slab,
            )
        )

    return PatchSet(
        dim=dim,
        k=k,
        P=P,
        levels=levels,
        class_offsets=class_offsets,
        stencil=stencil,
        stencil_slot=stencil_slot,
    )
