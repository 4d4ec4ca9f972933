"""Hand-written CUDA kernels for the 3D brick-patch stencil apply, each
beside its plain PyTorch twin (the counterpart of
admm_optim_tpu/ops/pallas_stencil.py).

Layout contract, as in the JAX package:
  x, y: (C, n0, n1, n2, P) with C = 3, or (B, C, n0, n1, n2, P) with a
        leading lane axis (the ADMM x-update's 1+m simultaneous solves);
        K5 and K5^T also take scalar fields, C = 1 (the pressure operators
        of the PCD Schur block); y is additive (per-patch partial sums, made consistent afterwards
        by patchstencil.exchange_sum);
  W:    (H, C, C, n0, n1, n2, P) symmetric half storage (H = 8 of O = 15
        slots, patchstencil.half_slots), full slot-major
        (O, C, C, n0, n1, n2, P) for a nonsymmetric operator, or
        pencil-major (n0, n1, O, C, C, n2, P) (to_pencil_major).  W is
        shared by all lanes.

Kernels (sources in ../csrc/stencil.cu, built on first use by _build):
  apply_w_sym             K1, replaces pallas_stencil._apply_w_pallas_3d_sym;
                          one field goes to the C = 3 kernel that K5 and
                          K5^T share, a lane axis (jax.vmap of it) to a
                          kernel that reads W once for 2 <= B <= 8 lanes
  apply_w_pencil          K2, replaces pallas_stencil._apply_w_pallas_3d_pc (bf16 W)
  apply_w_pencil_batched  K3, replaces pallas_stencil._apply_w_pallas_3d_pc_batched
                          (bf16 W read once for 1 <= B <= 8 lanes)
  apply_w_df_sym          K4, replaces pallas_stencil._apply_w_df_pallas_3d_sym
  apply_w_full            K5, replaces pallas_stencil._apply_w_pallas_3d (full W),
                          at C = 3 by the C = 3 kernel and, by a scalar
                          kernel of its own, at C = 1
  apply_w_full_t          K5^T, the exact transpose of K5 (the jax.vjp of
                          K5 in ns_solver.transpose_M); ApplyWFull is K5
                          with K5^T as its autograd backward
  assemble_hess           the ADMM x-update's Hessian stencil W_A +
                          Lambda . g'' in one launch; replaces no TPU kernel
                          (the JAX package leaves the assembly to XLA)
  constraint_grads        KC, the x-update's constraint gradients B = dg/du
                          in one launch; replaces no TPU kernel (XLA's
                          there too), its twin patchdeform
                          .constraint_grads_analytic_p

Dispatch is the same for all of them: a tensor on the CPU takes the plain
twin; a CUDA tensor launches the kernel or raises (assemble_hess and
constraint_grads also take the plain form on a 2D lattice, as
patchstencil.apply_w does: kernel_path).
There is no fallback and no lattice-size gate.  ``launches`` counts kernel launches per wrapper
(the twin never counts); the scalar form of K5 and K5^T counts under names
of its own, ``apply_w_full/c1`` and ``apply_w_full_t/c1``, and K1's lane
kernel as ``apply_w_sym/lanes``.  ``launches_by_lattice`` counts the same
launches per (name, (n0, n1, n2, P)).  A V-cycle replayed from a CUDA
graph (solvers.patch_mg.vcycle_p) adds the launches its capture counted.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from . import df
from .patchdeform import constraint_grads_analytic_p, hvp_corner_block_fn
from .patchstencil import assemble_w, expand_sym_w, half_slots, shift_read

launches = {
    "apply_w_sym": 0, "apply_w_sym/lanes": 0, "apply_w_pencil": 0, "apply_w_pencil_batched": 0,
    "apply_w_df_sym": 0, "apply_w_full": 0, "apply_w_full_t": 0, "apply_w_full/c1": 0, "apply_w_full_t/c1": 0,
    "assemble_hess": 0, "constraint_grads": 0,
}
# the same launches by lattice: (name, (n0, n1, n2, P)) -> count
launches_by_lattice = {}
MAX_LANES = 8  # K3 and K1's lane kernel are templated on the lane count up to this
BY_VALUE_SLOTS = 15  # the 3D stencil: what a by-value slot table holds
MAX_SITES = 2**31  # the kernels with a by-value table index lattice sites in 32 bits
HESS_CLASSES = (6, 4)  # the Hessian assembly's and KC's table: Kuhn classes of a 3D cell, corners of each
# Block size of the scalar kernel, a multiple of 32 up to 256 (64, 128 and
# 256 timed within 3% of each other at the PCD path's shapes on the H100).
SCALAR_THREADS = 64


def reset_launches():
    for k in launches:
        launches[k] = 0
    launches_by_lattice.clear()


# ---------------------------------------------------------------------------
# plain twins (the JAX package's XLA forms)
# ---------------------------------------------------------------------------

def _windows(xp, offsets, lat):
    """Slot windows x[s + o] of the zero-padded xp, stacked (n_off, C, S)."""
    C = xp.shape[0]
    ws = []
    for o in offsets:
        sl = (
            (slice(None),)
            + tuple(slice(1 + int(oo), 1 + int(oo) + n) for oo, n in zip(o, lat))
            + (slice(None),)
        )
        ws.append(xp[sl])
    return torch.stack(ws, dim=0).reshape(len(offsets), C, -1)


def _pad_lat(x, dim):
    """Zero halo of one site on every lattice axis (axes 1..dim)."""
    return torch.nn.functional.pad(x, (0, 0) + (1, 1) * dim)


def _apply_w_full(ps, W, x):
    """Full slot-major apply (O, C, C, *lat, P): y[c] = sum over slots o and
    components d of W[o, c, d] x[d] at s + o, accumulated one (o, d) pair
    at a time (no (O, C, C, S) temporary)."""
    dim = ps.dim
    lat = x.shape[1 : 1 + dim]
    C = x.shape[0]
    xp = _pad_lat(x, dim)
    Wf = W.reshape(W.shape[0], C, C, -1)  # (O, C, D, S)
    y = None
    for oi, o in enumerate(ps.stencil):
        xw = _windows(xp, [o], lat)[0]  # (D, S)
        for d in range(C):
            t = Wf[oi, :, d] * xw[d]
            y = t if y is None else y + t
    return y.reshape(x.shape)


def _apply_w_sym(ps, W, x):
    """Twin of K1: symmetric half-stencil apply.  Direct halves contract as
    in _apply_w_full; each missing slot -o adds the shifted transpose
    y[s] += W[o][:, :, s-o]^T x[s-o]."""
    dim = ps.dim
    lat = x.shape[1 : 1 + dim]
    C = x.shape[0]
    kept = half_slots(ps)
    H = len(kept)
    xw = _windows(_pad_lat(x, dim), [ps.stencil[k] for k in kept], lat)
    Wf = W.reshape(H, C, C, -1)  # (H, C, D, S)
    y = torch.sum(Wf * xw[:, None], dim=(0, 2)).reshape(x.shape)  # direct
    for h in range(1, H):
        o = ps.stencil[kept[h]]
        z = torch.sum(W[h] * x[:, None], dim=0)  # (C, *lat, P): W^T x
        y = y + shift_read(z, [-int(v) for v in o], lat_axes_offset=1)
    return y


def _apply_w_full_t(ps, W, x):
    """Twin of K5^T: the exact transpose of _apply_w_full, every slot o as
    a shifted transpose y[s] += W[o][:, :, s-o]^T x[s-o] (K1's missing-slot
    form over all slots)."""
    y = torch.zeros_like(x)
    for q, o in enumerate(ps.stencil):
        z = torch.sum(W[q] * x[:, None], dim=0)  # (D, *lat, P): W^T x
        y = y + shift_read(z, [-int(v) for v in o], lat_axes_offset=1)
    return y


def _apply_w_pencil(ps, W_pc, x):
    """Twin of K2: the pencil-major weights upcast to x's type, then the
    full-stencil contraction."""
    W = W_pc.permute(2, 3, 4, 0, 1, 5, 6).to(x.dtype)  # (O, C, C, n0, n1, n2, P)
    return _apply_w_full(ps, W, x)


def _lanes(fn, ps, W, x):
    """Plain apply fn(ps, W, field) on a field or on each lane of a lane
    axis (B, C, *lat, P), W shared."""
    if x.dim() == ps.dim + 3:
        return torch.stack([fn(ps, W, xb) for xb in x])
    return fn(ps, W, x)


def _apply_w_pencil_batched(ps, W_pc, xb):
    """Twin of K3: the pencil-major weights upcast once, then each lane's
    full-stencil contraction."""
    W = W_pc.permute(2, 3, 4, 0, 1, 5, 6).to(xb.dtype)
    return torch.stack([_apply_w_full(ps, W, x) for x in xb])


def _apply_w_df_full(ps, W, xh, xl):
    """Double-float full-stencil apply: each slot folds its C exact
    products (two_prod) into a (hi, lo) accumulator with two_sum, then one
    closing renormalization.  Twin of K4 after expand_sym_w."""
    if W.shape[0] != len(ps.stencil):
        raise ValueError("sym W must be expanded (expand_sym_w) first")
    dim = ps.dim
    lat = xh.shape[1 : 1 + dim]
    C = W.shape[1]
    O = len(ps.stencil)
    xhp = _pad_lat(xh, dim)
    xlp = _pad_lat(xl, dim)
    S = xh[0].numel()
    Wf = W.reshape(O, C, C, -1)  # (O, C, D, S)
    acc_h = xh.new_zeros((C, S))
    acc_l = acc_h
    for oi in range(O):
        w = Wf[oi]  # (C, D, S)
        xh_o = _windows(xhp, [ps.stencil[oi]], lat)[0]  # (D, S)
        xl_o = _windows(xlp, [ps.stencil[oi]], lat)[0]
        for d in range(C):
            p, e = df.two_prod(w[:, d], xh_o[d][None])
            lo = e + w[:, d] * xl_o[d][None]
            acc_h, t = df.two_sum(acc_h, p)
            acc_l = acc_l + t + lo
    s, e = df.two_sum(acc_h, acc_l)
    return s.reshape(xh.shape), e.reshape(xh.shape)


def _assemble_hess(ps, W_A, coords_p, u, Lmbda, free, pvalid=None):
    """Twin of the Hessian assembly kernel: W_A + pvalid * the constraint
    Hessian sum_k Lambda_k g_k'' assembled into W_A's storage (half or
    full) by patchstencil.assemble_w over patchdeform.hvp_corner_block_fn,
    its Dirichlet rows and columns zeroed by free."""
    sym = W_A.shape[0] != len(ps.stencil)
    W_h = assemble_w(ps, ps.k, torch.cat([coords_p, u], dim=0), hvp_corner_block_fn(Lmbda), sym=sym, free=free)
    if pvalid is not None:
        # padded dummy patches replicate real geometry; their Hessian
        # contributions must vanish like the pvalid-masked volumes do
        W_h = W_h * pvalid
    return W_A + W_h


def to_pencil_major(ps, W, dtype=None):
    """(O|H, C, C, n0, n1, n2, P) slot-major (full or symmetric half) ->
    (n0, n1, O, C, C, n2, P) pencil-major full stencil, expanding sym
    storage one output slot at a time: W[mu, c, d, s] = W[-mu, d, c, s+mu],
    a roll by -mu.  The wrapped entries sit where x is read outside the
    lattice, which every apply skips (or multiplies by the zero halo)."""
    O_full = len(ps.stencil)
    sym = W.shape[0] != O_full
    dtype = dtype or W.dtype
    stencil = [tuple(int(v) for v in o) for o in ps.stencil]
    if sym:
        pos = {h: i for i, h in enumerate(half_slots(ps))}
        neg = {oi: stencil.index(tuple(-v for v in o)) for oi, o in enumerate(stencil)}
    _, C, _, n0, n1, n2, P = W.shape
    out = torch.zeros((n0, n1, O_full, C, C, n2, P), dtype=dtype, device=W.device)
    for oi, o in enumerate(stencil):
        if not sym:
            blk = W[oi]
        elif oi in pos:
            blk = W[pos[oi]]
        else:
            pt = W[pos[neg[oi]]].transpose(0, 1)  # (C, C, n0, n1, n2, P)
            blk = torch.roll(pt, shifts=tuple(-v for v in o), dims=(2, 3, 4))
        out[:, :, oi] = blk.permute(2, 3, 0, 1, 4, 5).to(dtype)
    return out


def fill_unused_w(ps, W, value):
    """A copy of slot-major W (full or symmetric half) with every entry
    whose neighbour s + o lies outside the lattice set to value.  No apply
    uses such an entry: a direct read multiplies it by x outside the
    lattice, which is no term of the sum, and a transposed read at s never
    comes from a site inside.  So the result of every apply must be the
    same for any finite value; the tests and chip_smoke.py hold the twins
    and the kernels' clamped reads to that."""
    O = len(ps.stencil)
    slots = range(O) if W.shape[0] == O else half_slots(ps)
    W = W.clone()
    for h, oi in enumerate(slots):
        for ax, o in enumerate(ps.stencil[oi]):
            if o:
                idx = [slice(None)] * W[h].dim()
                idx[2 + ax] = -1 if o > 0 else 0
                W[h][tuple(idx)] = value
    return W


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _slot_rows(stencil, kept):
    """Per stencil slot its offset and a code: h >= 0 for a stored slot
    (W[h] at the site itself) or -1-h for a missing slot (the transpose of
    stored slot h at the neighbour)."""
    pos = {k: i for i, k in enumerate(kept)}
    rows = []
    for oi, o in enumerate(stencil):
        if oi in pos:
            code = pos[oi]
        else:
            code = -1 - pos[stencil.index(tuple(-v for v in o))]
        rows.append(list(o) + [code])
    return rows


def _transpose_rows(stencil):
    """The rows of K5^T: per slot q the offset -o_q and the code -1-q, so
    the kernel adds W[q](s-o_q)^T x[s-o_q]."""
    return [[-v for v in o] + [-1 - q] for q, o in enumerate(stencil)]


class StencilTables:
    """What a launch needs of one patchset's stencil, made once per
    patchset instead of once per call: the stencil and the class offsets
    as tuples, the half slots, K1's, K5's and K5^T's slot tables ("sym",
    "full", "full_t"), packed as the 15 x 4 C ints that every kernel takes
    by value, and the Hessian assembly's ("hess/half", "hess/full")."""

    def __init__(self, ps):
        self.stencil = tuple(tuple(int(v) for v in o) for o in ps.stencil)
        self.n_slots = len(self.stencil)
        self.kept = tuple(half_slots(ps))
        self.class_offsets = tuple(tuple(tuple(int(v) for v in c) for c in co) for co in ps.class_offsets)
        self._packed = {}

    def __getstate__(self):
        # a patchset handed to another process (parallel.launch) carries
        # its tables without the cache: ctypes arrays do not pickle, and
        # the packed tables are remade where they are used
        return {**self.__dict__, "_packed": {}}

    def rows(self, kind):
        if kind == "full_t":
            return _transpose_rows(self.stencil)
        kept = self.kept if kind == "sym" else tuple(range(self.n_slots))
        return _slot_rows(self.stencil, kept)

    def hess_rows(self, sym):
        """The Hessian assembly's table, flat: per class its corner offsets,
        then per class and corner pair (a, b) the storage position of the
        slot of offset co[b] - co[a] (half_slots order where sym), -1 where
        that slot is not stored.  The kernel adds pair (a, a) to its centre
        sums, so every such pair must sit at position 0, and no other."""
        co = self.class_offsets
        if (len(co), len(co[0])) != HESS_CLASSES:
            raise ValueError(f"the Hessian assembly takes {HESS_CLASSES} (classes, corners), "
                             f"got {(len(co), len(co[0]))}")
        kept = self.kept if sym else tuple(range(self.n_slots))
        pos = {k: i for i, k in enumerate(kept)}
        slot = {o: q for q, o in enumerate(self.stencil)}
        rows = [[[pos.get(slot[tuple(vb - va for va, vb in zip(ca, cb))], -1) for cb in c] for ca in c] for c in co]
        if any((p == 0) != (b == a) for c in rows for a, r in enumerate(c) for b, p in enumerate(r)):
            raise ValueError("the Hessian assembly needs the centre slot, and only it, at storage position 0")
        return [v for c in co for o in c for v in o] + [p for c in rows for r in c for p in r]

    def packed(self, kind):
        """The table of kind ("sym", "full", "full_t", "hess/half" and
        "hess/full", the Hessian assembly's, or "classes", KC's: the class
        offsets that head the Hessian assembly's) as C ints, made once."""
        tab = self._packed.get(kind)
        if tab is None:
            if self.n_slots != BY_VALUE_SLOTS:
                raise ValueError(f"the by-value table holds {BY_VALUE_SLOTS} slots, the stencil has {self.n_slots}")
            if kind == "classes":
                flat = self.hess_rows(True)[:math.prod(HESS_CLASSES) * 3]
            elif kind.startswith("hess/"):
                flat = self.hess_rows(kind == "hess/half")
            else:
                flat = [v for row in self.rows(kind) for v in row]
            tab = self._packed[kind] = (ctypes.c_int * len(flat))(*flat)
        return tab


def stencil_tables(ps):
    """The StencilTables of ps, kept on the patchset itself."""
    tabs = ps.__dict__.get("_stencil_tables")
    if tabs is None:
        tabs = ps.__dict__["_stencil_tables"] = StencilTables(ps)
    return tabs


def _check(name, ps, x, arrays, w_dtype, lane_axis=False, comps=(3,), max_sites=None):
    """Validate what the kernels take: 3D, C in comps, f32 fields (with a
    leading lane axis of 1 to MAX_LANES lanes iff lane_axis), contiguous,
    fewer than max_sites lattice sites where the kernel indexes them in 32
    bits, all on x's device.  Returns the lane count, C and the
    lattice (B, C, n0, n1, n2, P)."""
    if ps.dim != 3 or x.dim() != 5 + lane_axis or x.shape[-5] not in comps:
        want = " or ".join(str(c) for c in comps)
        lanes = "(B, C, n0, n1, n2, P)" if lane_axis else "(C, n0, n1, n2, P)"
        scalar = "" if 1 in comps else (
            "; the JAX package sends scalar fields only to the full-stencil apply and its transpose"
        )
        raise ValueError(
            f"{name}: the kernel takes 3D fields {lanes} with C = {want}, got x {tuple(x.shape)}{scalar}"
        )
    B = x.shape[0] if lane_axis else 1
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"{name}: the kernel takes 1 to {MAX_LANES} lanes, got {B}")
    W = arrays[0]
    if W.dtype != w_dtype:
        raise ValueError(f"{name}: W must be {w_dtype}, got {W.dtype}")
    for a in arrays:
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous on {x.device}")
    for a in arrays[1:]:
        if a.dtype != torch.float32 or a.shape != x.shape:
            raise ValueError(f"{name}: fields must be float32 of shape {tuple(x.shape)}")
    if max_sites is not None and math.prod(x.shape[-4:]) >= max_sites:
        raise ValueError(
            f"{name}: the kernel indexes lattice sites in 32 bits and takes fewer than {max_sites} "
            f"of them, got {tuple(x.shape[-4:])}"
        )
    return (B,) + tuple(x.shape[-5:])


def _launch(name, fn, lattice, *args, device):
    """Launch entry point fn of the kernel library on the current stream of
    a CUDA device and count it under name and under (name, lattice)."""
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, got {device}")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(_build.lib(), fn)(*args, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: {_build.error_string(err)}")
    launches[name] += 1
    key = (name, lattice)
    launches_by_lattice[key] = launches_by_lattice.get(key, 0) + 1


def launch_empty(device):
    """One launch of the library's empty kernel on the current stream: the
    floor under the device time of any single launch.  Counts nowhere."""
    device = torch.device(device)
    err = _build.lib().launch_empty(device.index or 0, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch_empty: CUDA launch failed: {_build.error_string(err)}")


def _c3(name, kind, ps, W, x, lattice):
    """Launch K1 (kind "sym"), K5 ("full") or K5^T ("full_t") on one field
    of C = 3 components, the table by value."""
    y = torch.empty_like(x)
    _launch(
        name, "apply_w_c3_f32", lattice, W.data_ptr(), x.data_ptr(), y.data_ptr(),
        stencil_tables(ps).packed(kind), *lattice, device=x.device,
    )
    return y


def apply_w_sym(ps, W, x):
    """K1: y = A x from symmetric half storage W (H, C, C, n0, n1, n2, P),
    for a field, or for the 2 to 8 lanes of (B, C, n0, n1, n2, P) in one
    launch that reads W once for all of them (a lane axis of one lane is
    the field's kernel); the lane form counts as "apply_w_sym/lanes"."""
    if x.device.type == "cpu":
        return _lanes(_apply_w_sym, ps, W, x)
    lane_axis = x.dim() == 6
    B, _, n0, n1, n2, P = _check("apply_w_sym", ps, x, (W, x), torch.float32, lane_axis, max_sites=MAX_SITES)
    tabs = stencil_tables(ps)
    if W.shape != (len(tabs.kept), 3, 3, n0, n1, n2, P):
        raise ValueError(f"apply_w_sym: W shape {tuple(W.shape)} does not match x")
    lattice = (n0, n1, n2, P)
    if B == 1:
        return _c3("apply_w_sym", "sym", ps, W, x, lattice)
    y = torch.empty_like(x)
    _launch(
        "apply_w_sym/lanes", "apply_w_sym_lanes_f32", lattice,
        W.data_ptr(), x.data_ptr(), y.data_ptr(), tabs.packed("sym"), *lattice, B, device=x.device,
    )
    return y


def _pencil(name, ps, W_pc, x, lane_axis):
    """Launch the bf16 pencil kernel (K2 for a field, K3 for a lane axis),
    K5's direct table by value (the kernel reads its offsets)."""
    B, _, n0, n1, n2, P = _check(name, ps, x, (W_pc, x), torch.bfloat16, lane_axis, max_sites=MAX_SITES)
    tabs = stencil_tables(ps)
    if W_pc.shape != (n0, n1, tabs.n_slots, 3, 3, n2, P):
        raise ValueError(f"{name}: W_pc shape {tuple(W_pc.shape)} does not match x")
    lattice = (n0, n1, n2, P)
    y = torch.empty_like(x)
    _launch(
        name, "apply_w_pencil_bf16", lattice, W_pc.data_ptr(), x.data_ptr(), y.data_ptr(),
        tabs.packed("full"), *lattice, B, device=x.device,
    )
    return y


def apply_w_pencil(ps, W_pc, x):
    """K2: full 15-slot apply from pencil-major bf16 W_pc
    (n0, n1, O, C, C, n2, P), f32 x and f32 accumulation."""
    if x.device.type == "cpu":
        return _apply_w_pencil(ps, W_pc, x)
    return _pencil("apply_w_pencil", ps, W_pc, x, lane_axis=False)


def apply_w_pencil_batched(ps, W_pc, xb):
    """K3: K2 for the lanes xb (B, C, n0, n1, n2, P) sharing one W_pc, in
    one launch that reads each weight once for all B <= 8 lanes."""
    if xb.device.type == "cpu":
        return _apply_w_pencil_batched(ps, W_pc, xb)
    return _pencil("apply_w_pencil_batched", ps, W_pc, xb, lane_axis=True)


def apply_w_df_sym(ps, W, xh, xl):
    """K4: (yh, yl) = A (xh + xl) from symmetric half storage W, as a
    renormalized f32 pair (|yl| <= ulp(yh)/2), K1's table by value."""
    if xh.device.type == "cpu":
        return _apply_w_df_full(ps, expand_sym_w(ps, W), xh, xl)
    _, _, n0, n1, n2, P = _check("apply_w_df_sym", ps, xh, (W, xh, xl), torch.float32, max_sites=MAX_SITES)
    tabs = stencil_tables(ps)
    if W.shape != (len(tabs.kept), 3, 3, n0, n1, n2, P):
        raise ValueError(f"apply_w_df_sym: W shape {tuple(W.shape)} does not match x")
    lattice = (n0, n1, n2, P)
    yh = torch.empty_like(xh)
    yl = torch.empty_like(xh)
    _launch(
        "apply_w_df_sym", "apply_w_df_sym_f32", lattice,
        W.data_ptr(), xh.data_ptr(), xl.data_ptr(), yh.data_ptr(), yl.data_ptr(),
        tabs.packed("sym"), *lattice, device=xh.device,
    )
    return yh, yl


def _full(name, kind, ps, W, x):
    """Launch K5 (kind "full") or K5^T ("full_t") on one field of C = 3 or
    C = 1 components, full slot-major f32 W.  The scalar form has a kernel
    of its own and counts as name + "/c1"."""
    _, C, n0, n1, n2, P = _check(name, ps, x, (W, x), torch.float32, comps=(1, 3), max_sites=MAX_SITES)
    tabs = stencil_tables(ps)
    if W.shape != (tabs.n_slots, C, C, n0, n1, n2, P):
        raise ValueError(f"{name}: W shape {tuple(W.shape)} does not match x")
    lattice = (n0, n1, n2, P)
    if C == 3:
        return _c3(name, kind, ps, W, x, lattice)
    y = torch.empty_like(x)
    _launch(
        name + "/c1", "apply_w_scalar_f32", lattice, W.data_ptr(), x.data_ptr(), y.data_ptr(),
        tabs.packed(kind), *lattice, SCALAR_THREADS, device=x.device,
    )
    return y


def apply_w_full(ps, W, x):
    """K5: y = A x from full slot-major W (O, C, C, n0, n1, n2, P) of a
    nonsymmetric operator: C = 3 in the NS conv-diff velocity V-cycle,
    C = 1 in the PCD Schur block (the pressure convection-diffusion
    stencil and the pressure-Laplacian V-cycle)."""
    if x.device.type == "cpu":
        return _apply_w_full(ps, W, x)
    return _full("apply_w_full", "full", ps, W, x)


def apply_w_full_t(ps, W, x):
    """K5^T: y = A^T x for the same W, a gather of shifted transposes."""
    if x.device.type == "cpu":
        return _apply_w_full_t(ps, W, x)
    return _full("apply_w_full_t", "full_t", ps, W, x)


def kernel_path(ps, u):
    """Which form assemble_hess and constraint_grads take for the field u:
    "kernel" for a 3D CUDA field, "plain" otherwise."""
    return "kernel" if ps.dim == 3 and u.device.type == "cuda" else "plain"


def assemble_hess(ps, W_A, coords_p, u, Lmbda, free, pvalid=None):
    """W_H = W_A + pvalid * sum_k Lambda_k g_k'' in W_A's storage, symmetric
    half (H = 8 slots) or full slot-major (O = 15), the constraint Hessian's
    Dirichlet rows and columns zeroed by free: the matrix of the ADMM
    x-update's Newton step, assembled once a step.  coords_p and u
    (3, n0, n1, n2, P), Lmbda (4,), free (n0, n1, n2, P), pvalid (P,) or
    None, all float32 on one CUDA device: one launch of the kernel; a CPU
    tensor or a 2D lattice: the plain twin (kernel_path)."""
    if kernel_path(ps, u) == "plain":
        return _assemble_hess(ps, W_A, coords_p, u, Lmbda, free, pvalid)
    _, _, n0, n1, n2, P = _check("assemble_hess", ps, u, (W_A, coords_p, u), torch.float32, max_sites=MAX_SITES)
    tabs = stencil_tables(ps)
    lattice = (n0, n1, n2, P)
    H = W_A.shape[0]
    if H not in (len(tabs.kept), tabs.n_slots) or W_A.shape != (H, 3, 3) + lattice:
        raise ValueError(f"assemble_hess: W_A shape {tuple(W_A.shape)} does not match u")
    extra = [(Lmbda, (4,)), (free, lattice)] + ([] if pvalid is None else [(pvalid, (P,))])
    for a, shape in extra:
        if a.dtype != torch.float32 or a.shape != shape or a.device != u.device or not a.is_contiguous():
            raise ValueError(f"assemble_hess: Lambda, free and pvalid must be contiguous float32 of shapes (4,), "
                             f"{lattice} and ({P},) on {u.device}")
    kind = "hess/half" if H == len(tabs.kept) else "hess/full"
    W_H = torch.empty_like(W_A)
    _launch(
        "assemble_hess", "assemble_hess_f32", lattice, W_A.data_ptr(), coords_p.data_ptr(), u.data_ptr(),
        Lmbda.data_ptr(), free.data_ptr(), None if pvalid is None else pvalid.data_ptr(), W_H.data_ptr(),
        tabs.packed(kind), *lattice, H, device=u.device,
    )
    return W_H


def constraint_grads(ps, geo, coords_p, u, pvalid=None):
    """B = dg/du (4, 3, n0, n1, n2, P), additive: the derivatives of the
    volume and the three barycenter constraints, the ADMM x-update's
    constraint gradients, once a Newton step.  coords_p and u (3, n0, n1,
    n2, P), pvalid (P,) or None, all float32 on one CUDA device: one launch
    of KC, which derives its cells from coords_p; a CPU tensor or a 2D
    lattice: the plain twin patchdeform.constraint_grads_analytic_p over
    geo, the cell geometry of coords_p and pvalid (kernel_path)."""
    if kernel_path(ps, u) == "plain":
        return constraint_grads_analytic_p(ps, geo, u, 0.0, None)
    # u first as the array whose dtype _check holds, then coords_p to u's shape
    _, _, n0, n1, n2, P = _check("constraint_grads", ps, u, (u, coords_p), torch.float32, max_sites=MAX_SITES)
    if pvalid is not None and (pvalid.dtype != torch.float32 or pvalid.shape != (P,) or pvalid.device != u.device
                               or not pvalid.is_contiguous()):
        raise ValueError(f"constraint_grads: pvalid must be contiguous float32 of shape ({P},) on {u.device}")
    lattice = (n0, n1, n2, P)
    B = u.new_empty((4,) + tuple(u.shape))
    _launch(
        "constraint_grads", "constraint_grads_f32", lattice, coords_p.data_ptr(), u.data_ptr(),
        None if pvalid is None else pvalid.data_ptr(), B.data_ptr(), stencil_tables(ps).packed("classes"),
        *lattice, device=u.device,
    )
    return B


class ApplyWFull(torch.autograd.Function):
    """K5 as a function of x alone, like the JAX package's custom VJP that
    closes over W: the backward is K5^T (its twin on CPU tensors).  A
    gradient with respect to W is not provided and raises."""

    @staticmethod
    def forward(ps, W, x):
        return apply_w_full(ps, W, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ps, W, _ = inputs
        ctx.ps = ps
        ctx.save_for_backward(W)

    @staticmethod
    def backward(ctx, gy):
        if ctx.needs_input_grad[1]:
            raise RuntimeError("ApplyWFull is differentiable in x only, not in W")
        (W,) = ctx.saved_tensors
        return None, None, apply_w_full_t(ctx.ps, W, gy.contiguous())
