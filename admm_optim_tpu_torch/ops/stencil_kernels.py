"""Hand-written CUDA kernels for the 3D brick-patch stencil apply, each
beside its plain PyTorch twin (the counterpart of
admm_optim_tpu/ops/pallas_stencil.py).

Layout contract, as in the JAX package:
  x, y: (C, n0, n1, n2, P) with C = 3; y is additive (per-patch partial
        sums, made consistent afterwards by patchstencil.exchange_sum);
  W:    (H, C, C, n0, n1, n2, P) symmetric half storage (H = 8 of O = 15
        slots, patchstencil.half_slots), or pencil-major
        (n0, n1, O, C, C, n2, P) (to_pencil_major).

Kernels (sources in ../csrc/stencil.cu, built on first use by _build):
  apply_w_sym     K1, replaces pallas_stencil._apply_w_pallas_3d_sym
  apply_w_pencil  K2, replaces pallas_stencil._apply_w_pallas_3d_pc (bf16 W)
  apply_w_df_sym  K4, replaces pallas_stencil._apply_w_df_pallas_3d_sym

Dispatch is the same for all three: a tensor on the CPU takes the plain
twin; a CUDA tensor launches the kernel or raises.  There is no fallback
and no lattice-size gate.  ``launches`` counts kernel launches per wrapper
(the twin never counts).
"""
from __future__ import annotations

import functools

import torch

from . import df
from .patchstencil import expand_sym_w, half_slots, shift_read

launches = {"apply_w_sym": 0, "apply_w_pencil": 0, "apply_w_df_sym": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


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
    """Full slot-major apply (O, C, C, *lat, P): all slots contract in one
    broadcast multiply + reduction over (slot, component)."""
    dim = ps.dim
    lat = x.shape[1 : 1 + dim]
    C = x.shape[0]
    O = len(ps.stencil)
    xw = _windows(_pad_lat(x, dim), ps.stencil, lat)  # (O, D, S)
    Wf = W.reshape(O, C, C, -1)  # (O, C, D, S)
    return torch.sum(Wf * xw[:, None], dim=(0, 2)).reshape(x.shape)


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


def _apply_w_pencil(ps, W_pc, x):
    """Twin of K2: the pencil-major weights upcast to x's type, then the
    full-stencil contraction."""
    W = W_pc.permute(2, 3, 4, 0, 1, 5, 6).to(x.dtype)  # (O, C, C, n0, n1, n2, P)
    return _apply_w_full(ps, W, x)


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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _slot_table(stencil, kept, device):
    """(O, 4) int32 on the device: per stencil slot its offset and a code,
    h >= 0 for a stored slot (W[h] at the site itself) or -1-h for a
    missing slot (the transpose of stored slot h at the neighbour)."""
    pos = {k: i for i, k in enumerate(kept)}
    rows = []
    for oi, o in enumerate(stencil):
        if oi in pos:
            code = pos[oi]
        else:
            code = -1 - pos[stencil.index(tuple(-v for v in o))]
        rows.append(list(o) + [code])
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _stencil_key(ps):
    return tuple(tuple(int(v) for v in o) for o in ps.stencil)


def _check(name, ps, x, arrays, w_dtype):
    """Validate what the kernels take: 3D, C = 3, f32 fields, contiguous,
    all on x's CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, got {x.device}")
    if ps.dim != 3 or x.dim() != 5 or x.shape[0] != 3:
        raise ValueError(f"{name}: the kernel takes 3D lattices with C = 3, got x {tuple(x.shape)}")
    W = arrays[0]
    if W.dtype != w_dtype:
        raise ValueError(f"{name}: W must be {w_dtype}, got {W.dtype}")
    for a in arrays:
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous on {x.device}")
    for a in arrays[1:]:
        if a.dtype != torch.float32 or a.shape != x.shape:
            raise ValueError(f"{name}: fields must be float32 of shape {tuple(x.shape)}")


def _launch(name, fn, *args, device):
    from .. import _build

    lib = _build.lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(*args, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: {_build.error_string(err)}")
    launches[name] += 1


def apply_w_sym(ps, W, x):
    """K1: y = A x from symmetric half storage W (H, C, C, n0, n1, n2, P)."""
    if x.device.type == "cpu":
        return _apply_w_sym(ps, W, x)
    _check("apply_w_sym", ps, x, (W, x), torch.float32)
    n0, n1, n2, P = x.shape[1:]
    if W.shape != (len(half_slots(ps)), 3, 3, n0, n1, n2, P):
        raise ValueError(f"apply_w_sym: W shape {tuple(W.shape)} does not match x")
    stencil = _stencil_key(ps)
    tab = _slot_table(stencil, tuple(half_slots(ps)), x.device)
    y = torch.empty_like(x)
    _launch(
        "apply_w_sym", "apply_w_sym_f32",
        W.data_ptr(), x.data_ptr(), y.data_ptr(), tab.data_ptr(),
        len(stencil), n0, n1, n2, P, device=x.device,
    )
    return y


def apply_w_pencil(ps, W_pc, x):
    """K2: full 15-slot apply from pencil-major bf16 W_pc
    (n0, n1, O, C, C, n2, P), f32 x and f32 accumulation."""
    if x.device.type == "cpu":
        return _apply_w_pencil(ps, W_pc, x)
    _check("apply_w_pencil", ps, x, (W_pc, x), torch.bfloat16)
    n0, n1, n2, P = x.shape[1:]
    stencil = _stencil_key(ps)
    if W_pc.shape != (n0, n1, len(stencil), 3, 3, n2, P):
        raise ValueError(f"apply_w_pencil: W_pc shape {tuple(W_pc.shape)} does not match x")
    tab = _slot_table(stencil, tuple(range(len(stencil))), x.device)
    y = torch.empty_like(x)
    _launch(
        "apply_w_pencil", "apply_w_pencil_bf16",
        W_pc.data_ptr(), x.data_ptr(), y.data_ptr(), tab.data_ptr(),
        len(stencil), n0, n1, n2, P, device=x.device,
    )
    return y


def apply_w_df_sym(ps, W, xh, xl):
    """K4: (yh, yl) = A (xh + xl) from symmetric half storage W, as a
    renormalized f32 pair (|yl| <= ulp(yh)/2)."""
    if xh.device.type == "cpu":
        return _apply_w_df_full(ps, expand_sym_w(ps, W), xh, xl)
    _check("apply_w_df_sym", ps, xh, (W, xh, xl), torch.float32)
    n0, n1, n2, P = xh.shape[1:]
    if W.shape != (len(half_slots(ps)), 3, 3, n0, n1, n2, P):
        raise ValueError(f"apply_w_df_sym: W shape {tuple(W.shape)} does not match x")
    stencil = _stencil_key(ps)
    tab = _slot_table(stencil, tuple(half_slots(ps)), xh.device)
    yh = torch.empty_like(xh)
    yl = torch.empty_like(xh)
    _launch(
        "apply_w_df_sym", "apply_w_df_sym_f32",
        W.data_ptr(), xh.data_ptr(), xl.data_ptr(), yh.data_ptr(), yl.data_ptr(),
        tab.data_ptr(), len(stencil), n0, n1, n2, P, device=xh.device,
    )
    return yh, yl
