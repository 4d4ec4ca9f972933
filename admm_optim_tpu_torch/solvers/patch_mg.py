"""Geometric multigrid on brick-patch lattices (port of
admm_optim_tpu/solvers/patch_mg.py).

Chebyshev-smoothed V-cycle with a dense level-0 base solve, on the patch
stencil representation (ops.patchstencil); MG-preconditioned CG on the fine
level; and double-float iterative refinement (``cg_ir_p``) down to
below-f32 true residuals.  Loops run on the host; every level operation is
a stencil apply (ops.stencil_kernels) plus the duplicate-site exchange.

With ``PatchMGStructure.spmd`` set (parallel.patch_shard) the same code
runs on one rank's patch block: exchanges, dots and the base-solve glue
take the sharded forms of ops.patchstencil, and levels below
``replicate_below`` run agglomerated (every rank holds them whole).

On a CUDA device ``vcycle_p`` captures a cycle from zero into a CUDA graph
and replays it, one host launch for its ~700 kernels; the graphs live on
the PatchMGData and are keyed by what the cycle reads (``cycle_key``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.patches import PatchSet
from ..ops import df
from ..ops import patchstencil as st
from ..ops import stencil_kernels as sk
from ..utils.profiling import host_read, recording, span
from . import krylov


@dataclasses.dataclass(frozen=True)
class PatchMGStructure:
    ps: PatchSet
    pre_smooth: int = 3
    post_smooth: int = 3
    cheb_lower: float = 0.25
    # "chebyshev" (SPD operators) | "jacobi" (nonsymmetric operators)
    smoother: str = "chebyshev"
    # smoother-stream W precision: "auto" stores an ADDITIONAL bf16
    # pencil-major copy of each large 3D level's stencil on the GPU and
    # smooths with it (the V-cycle is a preconditioner, so bf16 weights
    # only perturb M; A-applies and DF residuals keep the f32 sym W).
    # "f32" disables.
    smoother_w: str = "auto"
    # set (parallel.patch_shard) to run on one rank's patch block
    spmd: st.SpmdCtx | None = None
    # level-wise agglomeration under spmd (the reference's process
    # hierarchy, 2d_admm.lua:174-206): levels l < replicate_below are held
    # whole on every rank; the restriction into the first of them gathers
    # the residual once, and the cycle below it runs without collectives
    replicate_below: int = 0

    def level_spmd(self, l: int):
        """The sharding of level l: spmd, or None where it is agglomerated."""
        return self.spmd if l >= self.replicate_below else None


@dataclasses.dataclass
class PatchMGData:
    """Device data per level."""

    W: list  # per level: (H|O, C, C, *lat, P) slot-major baked stencils
    inv_diag: list  # per level: (C, *lat, P) consistent 1/diag (1 at fixed)
    lmax: list  # per level 0-d tensor
    base_inv: torch.Tensor  # dense inverse of the level-0 operator (C*V0 sq)
    tabs: list  # per level: st.LevelTables
    # optional per-level smoother stencils (PencilW; None entries use W)
    W_sm: list | None = None
    # vcycle_p's CUDA graphs: {"key": cycle_key, "cycles": {input key:
    # "warm" after one eager cycle, then a _CycleGraph}}; a new instance
    # (dataclasses.replace too) starts without
    graphs: dict | None = dataclasses.field(default=None, init=False, repr=False, compare=False)

    def smoother_W(self, l):
        if self.W_sm is None or self.W_sm[l] is None:
            return self.W[l]
        return self.W_sm[l]


def _apply(ps, tab, W, x, spmd=None):
    """exchange(A x) restricted to the free subspace."""
    y = st.exchange_sum(None, st.apply_w(ps, W, x), tab, spmd=spmd)
    return y * tab.free[None].to(x.dtype)


def _lmax_init(shape, dtype, device, spmd=None):
    """Deterministic start vector sin(flat index) + 1, the flat index that
    of the whole (C, *lat, P) array, so that a rank's block starts where
    the single device does (the JAX package's)."""
    Pl = shape[-1]
    off = 0 if spmd is None else spmd.offset(Pl)
    P = Pl if spmd is None else Pl * spmd.nshards
    S = int(np.prod(shape[1:-1]))
    cs = torch.arange(shape[0] * S, device=device).reshape(shape[:-1] + (1,))
    flat = cs * P + torch.arange(off, off + Pl, device=device)
    return torch.sin(flat.to(dtype)) + 1.0


def estimate_lmax_p(ps, tab, W, inv_diag, iters: int = 15, spmd=None):
    """Power iteration for lambda_max(D^-1 A) with owner-weighted norms."""
    x = _lmax_init(inv_diag.shape, inv_diag.dtype, inv_diag.device, spmd)
    x = st.exchange_sum(None, x, tab, spmd=spmd) * tab.free[None].to(x.dtype)

    def dot(u, v):
        return st.owner_dot(None, u, v, tab, spmd=spmd)

    def normalized(v):
        return v / torch.clamp_min(torch.sqrt(dot(v, v)), 1e-30)

    x = normalized(x)
    for _ in range(iters):
        x = normalized(inv_diag * _apply(ps, tab, W, x, spmd))
    y = inv_diag * _apply(ps, tab, W, x, spmd)
    return dot(x, y) / dot(x, x) * 1.1


def make_level_tables(ps: PatchSet, dtype=torch.float32, device="cpu", spmd=None, replicate_below: int = 0):
    """Device tables for every level; with spmd those of its rank's patch
    block on levels >= replicate_below, whole tables below."""
    return [st.make_tables(lvl, dtype, device, shard=spmd if l >= replicate_below else None)
            for l, lvl in enumerate(ps.levels)]


def vcycle_cost_table(struct: PatchMGStructure, data: PatchMGData, hbm_gbps: float) -> str:
    """Per-level V-cycle cost table: device-memory bytes and flops per level
    per cycle from the assembled stencil shapes, with a bandwidth-roofline
    time at ``hbm_gbps`` (the card's published bandwidth; required).

    Per level: (pre+post) smoothing applies + 1 residual apply, each
    streaming the smoother's W once (the bf16 pencil copy where there is
    one) plus x and y.  Sym-stored levels stream half the W bytes at
    full-stencil flops."""
    rows = []
    tot_gb = tot_gf = 0.0
    n_apply = struct.pre_smooth + struct.post_smooth + 1
    O_full = len(struct.ps.stencil)
    for l, W in enumerate(data.W):
        Wsm = data.smoother_W(l)
        pencil = isinstance(Wsm, st.PencilW)
        Ws = Wsm.a if pencil else Wsm
        C = W.shape[1]
        lat = W.shape[3:-1]
        P = W.shape[-1]
        S = int(np.prod(lat))
        O = O_full if pencil else W.shape[0]
        store = "bf16pc" if pencil else ("sym" if O < O_full else "full")
        w_bytes = O * C * C * S * P * Ws.element_size()
        xy_bytes = 2 * C * S * P * W.element_size()
        gb = n_apply * (w_bytes + xy_bytes) / 1e9
        gf = n_apply * 2.0 * O_full * C * C * S * P / 1e9
        tot_gb += gb
        tot_gf += gf
        rows.append(
            (l, "x".join(map(str, lat)), P, C, O, store, w_bytes / 2**20, gb, gf,
             gb / hbm_gbps * 1e3)
        )
    lines = [
        f"{'lvl':>3} {'lat':>12} {'P':>6} {'C':>2} {'O':>3} {'store':>6} "
        f"{'W[MiB]':>9} {'GB/cyc':>8} {'GF/cyc':>8} {'roofln[ms]':>10}"
    ]
    for r in rows:
        lines.append(
            f"{r[0]:>3} {r[1]:>12} {r[2]:>6} {r[3]:>2} {r[4]:>3} {r[5]:>6} "
            f"{r[6]:>9.2f} {r[7]:>8.4f} {r[8]:>8.3f} {r[9]:>10.3f}"
        )
    lines.append(
        f"total: {tot_gb:.4f} GB, {tot_gf:.3f} GFLOP per V-cycle; "
        f"roofline {tot_gb / hbm_gbps * 1e3:.3f} ms @ {hbm_gbps:.0f} GB/s"
    )
    return "\n".join(lines)


def assemble_patch_mg_p(
    ps: PatchSet,
    struct: PatchMGStructure,
    coords_p: torch.Tensor,  # (d, *latf, P) fine lattice coordinates
    corner_mat_fn: Callable,  # corners (d, nl, ...) -> (C,C,nl,nl,...) or blk
    base_dense_fn: Callable,  # coords0 (V0, d) -> dense inverse (C*V0, C*V0)
    tabs: list,
    sym: bool = False,  # symmetric half-stencil storage (SPD operators only)
) -> PatchMGData:
    """Assemble all levels from patch-layout geometry (rediscretized coarse
    operators from the nested lattice coordinates).  Under struct.spmd,
    coords_p is the rank's block: each rank assembles its block of the
    sharded levels, and every rank the whole of an agglomerated level, from
    the gathered coordinates (small); the base operator comes from the
    gathered level-0 coordinates."""
    spmd = struct.spmd
    W_l, invd_l, lmax_l = [], [], []
    for l in range(len(ps.levels)):
        stride = 2 ** (ps.k - l)
        cp = coords_p[(slice(None),) + (slice(0, None, stride),) * ps.dim]
        lvl_spmd = struct.level_spmd(l)
        if spmd is not None and lvl_spmd is None:
            cp = spmd.all_gather_p(cp)
        free = tabs[l].free.to(cp.dtype)
        W = st.assemble_w(ps, l, cp, corner_mat_fn, sym=sym, free=free)
        diag = st.exchange_sum(None, st.stencil_diag(ps, l, W), tabs[l], spmd=lvl_spmd)
        diag = torch.where(free[None] > 0, diag, torch.ones_like(diag))
        inv_diag = 1.0 / diag
        W_l.append(W)
        invd_l.append(inv_diag)
        lmax_l.append(estimate_lmax_p(ps, tabs[l], W, inv_diag, spmd=lvl_spmd))
    V0 = int(ps.levels[0].gid.max()) + 1
    cp0 = coords_p[(slice(None),) + (slice(0, None, 2**ps.k),) * ps.dim]
    if spmd is not None and struct.replicate_below > 0:
        cp0 = spmd.all_gather_p(cp0)  # tabs[0] is whole
    coords0 = st.from_patch_tab(tabs[0], cp0, V0, spmd=struct.level_spmd(0))  # (d, V0)
    base_inv = base_dense_fn(coords0.T)
    plan = smoother_w_plan(struct, ps, coords_p.dtype, coords_p.device)
    W_sm = None
    if plan is not None:
        W_sm = [
            st.PencilW(sk.to_pencil_major(ps, W, torch.bfloat16)) if on else None
            for on, W in zip(plan, W_l)
        ]
    return PatchMGData(W_l, invd_l, lmax_l, base_inv, tabs, W_sm)


# minimum lattice edge for the bf16 smoother stream: the JAX package's
# criterion, kept so iteration counts stay comparable to its records; a
# gate of the GPU's own comes from a measurement on the card
SMOOTHER_STREAM_MIN_LAT = 9


def smoother_w_plan(struct: PatchMGStructure, ps: PatchSet, dtype, device):
    """Which levels carry a bf16 pencil-major smoother stencil (None =
    feature off): 3D f32 on a CUDA device, lattice edge >= 9."""
    if not (
        struct.smoother_w == "auto"
        and ps.dim == 3
        and torch.device(device).type == "cuda"
        and dtype == torch.float32
    ):
        return None
    plan = [min(lvl.lat_shape) >= SMOOTHER_STREAM_MIN_LAT for lvl in ps.levels]
    return plan if any(plan) else None


def assemble_patch_mg(
    ps: PatchSet,
    struct: PatchMGStructure,
    coords_global: torch.Tensor,  # (V, d) current fine-mesh coordinates
    corner_mat_fn: Callable,
    base_dense_fn: Callable,
    tabs: list | None = None,
    sym: bool = False,
) -> PatchMGData:
    """Global coords -> patch layout -> assemble."""
    if tabs is None:
        tabs = make_level_tables(ps, coords_global.dtype, coords_global.device)
    coords_p = st.to_patch(ps.fine, coords_global.T)  # (d, *latf, P)
    return assemble_patch_mg_p(
        ps, struct, coords_p, corner_mat_fn, base_dense_fn, tabs, sym=sym
    )


def chebyshev_smooth_p(ps, tab, W, inv_diag, lmax, x, b, degree, lower, x_is_zero=False, spmd=None):
    """Chebyshev iteration on patch arrays; x, b consistent.  x_is_zero:
    skip the first stencil apply (A.0 = 0, so r = b exactly)."""
    lmin = lower * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    free = tab.free[None].to(x.dtype)

    r = b * free if x_is_zero else (b - _apply(ps, tab, W, x, spmd)) * free
    z = inv_diag * r
    d_vec = z / theta
    x = x + d_vec
    # rho_0 = delta/theta seeds the Chebyshev rho-recurrence (Saad Alg. 12.1)
    sigma_old = delta / theta if degree > 1 else 1.0
    for _ in range(degree - 1):
        r = (b - _apply(ps, tab, W, x, spmd)) * free
        z = inv_diag * r
        sigma_new = 1.0 / (2.0 * theta / delta - sigma_old)
        d_vec = (2.0 * sigma_new / delta) * z + (sigma_new * sigma_old) * d_vec
        x = x + d_vec
        sigma_old = sigma_new
    return x


def jacobi_smooth_p(ps, tab, W, inv_diag, lmax, x, b, degree, omega=0.7, x_is_zero=False, spmd=None):
    """Damped Jacobi on patch arrays (nonsymmetric operators); damping
    scaled by the power-iteration bound."""
    free = tab.free[None].to(x.dtype)
    scale = omega / torch.clamp_min(lmax, 1e-30)
    n = degree
    if x_is_zero and degree >= 1:
        x = x + scale * (inv_diag * (b * free))
        n = degree - 1
    for _ in range(n):
        r = (b - _apply(ps, tab, W, x, spmd)) * free
        x = x + scale * (inv_diag * r)
    return x


def _vcycle(struct: PatchMGStructure, data: PatchMGData, b, x0=None):
    """vcycle_p's launches, run eagerly."""
    ps = struct.ps
    spmd = struct.spmd

    def smooth(l, x, b_l, degree, x_zero=False):
        args = (ps, data.tabs[l], data.smoother_W(l), data.inv_diag[l], data.lmax[l], x, b_l, degree)
        sp = struct.level_spmd(l)
        with span("mg.smooth", level=l):
            if struct.smoother == "jacobi":
                return jacobi_smooth_p(*args, x_is_zero=x_zero, spmd=sp)
            return chebyshev_smooth_p(*args, struct.cheb_lower, x_is_zero=x_zero, spmd=sp)

    def solve_level(l, b_l, x_l, x_zero=False):
        tab = data.tabs[l]
        if l == 0:
            # dense base solve: consistent residual -> owner-picked global
            # (all-reduced when level 0 is sharded) -> dense inverse -> patch
            with span("mg.base"):
                n = data.base_inv.shape[0]  # C * V0
                C = b_l.shape[-ps.dim - 2]
                bg = st.from_patch_tab(tab, b_l, n // C, mode="owner", spmd=struct.level_spmd(0))
                xg = (bg.reshape(-1, n) @ data.base_inv.T).reshape(bg.shape)
                return st.to_patch_tab(tab, xg)
        x_l = smooth(l, x_l, b_l, struct.pre_smooth, x_zero)
        agglom_edge = spmd is not None and l == struct.replicate_below
        with span("mg.transfer", level=l, dir="restrict"):
            # restriction acts on the ADDITIVE residual: owner-weighted b
            # minus the raw per-patch partial sums (restricting a consistent
            # vector would double-count duplicated sites)
            owner = tab.owner.to(b_l.dtype)
            r_add = b_l * owner[None] - st.apply_w(ps, data.smoother_W(l), x_l)
            rc = st.restrict_p(ps, l - 1, r_add)
            tab_c = data.tabs[l - 1]
            if agglom_edge:
                rc = spmd.all_gather_p(rc)
            rc = st.exchange_sum(None, rc, tab_c, spmd=struct.level_spmd(l - 1)) * tab_c.free[None].to(rc.dtype)
        ec = solve_level(l - 1, rc, torch.zeros_like(rc), x_zero=True)
        with span("mg.transfer", level=l, dir="prolong"):
            if agglom_edge:
                ec = spmd.take_block(ec)
            x_l = x_l + st.prolong_p(ps, l - 1, ec) * tab.free[None].to(x_l.dtype)
        return smooth(l, x_l, b_l, struct.post_smooth)

    x_zero = x0 is None
    if x0 is None:
        x0 = torch.zeros_like(b)
    return solve_level(ps.k, b, x0, x_zero=x_zero)


# V-cycles by how vcycle_p ran them: eagerly, captured into a CUDA graph
# (and replayed once for the caller), or replayed from one
graph_counts = {"eager": 0, "capture": 0, "replay": 0}


def reset_graph_counts():
    for k in graph_counts:
        graph_counts[k] = 0


@dataclasses.dataclass
class _CycleGraph:
    graph: torch.cuda.CUDAGraph
    b: torch.Tensor  # the static input, b copied in before each replay
    x: torch.Tensor  # the static output, copied out after each replay
    launches: dict  # stencil_kernels.launches of one cycle
    by_lattice: dict  # stencil_kernels.launches_by_lattice of one cycle


def _cycle_tensors(data: PatchMGData) -> list:
    """Every tensor of data that a cycle reads."""
    out = [data.base_inv]
    for l, tab in enumerate(data.tabs):
        out += [data.W[l], data.inv_diag[l], data.lmax[l], tab.owner, tab.free, tab.gid, tab.bslots, tab.bseg,
                *tab.dfg_bidx]
        if data.W_sm is not None and data.W_sm[l] is not None:
            out.append(data.W_sm[l].a)
    return out


def cycle_key(struct: PatchMGStructure, data: PatchMGData) -> tuple:
    """What a captured cycle depends on beyond its input: the structure's
    settings and, of each tensor of data it reads, the address, shape,
    stride and dtype (and whether it requires grad).  A list entry
    replaced or data assembled anew changes it; a write into the same
    storage does not, and a replay sees that write as an eager cycle
    would."""
    return (id(struct.ps), struct.pre_smooth, struct.post_smooth, struct.cheb_lower, struct.smoother,
            tuple([(t.data_ptr(), t.shape, t.stride(), t.dtype, t.requires_grad) for t in _cycle_tensors(data)]))


def _graph_mode(struct: PatchMGStructure, data: PatchMGData, b, x0):
    """How vcycle_p runs this call, and the graph to replay or the input
    key to capture under.  Eager unless b is on a CUDA device, the cycle
    is not sharded (its collectives run on the host), starts from zero,
    nothing it reads requires grad, and no capture is under way.  Then the
    first call under a key runs eagerly (it makes the lazy tables and the
    library's handles), the second captures, or stays eager while a
    profiler records, and every later call replays."""
    if (not b.is_cuda or struct.spmd is not None or x0 is not None or b.requires_grad
            or torch.cuda.is_current_stream_capturing()):
        return "eager", None
    key = cycle_key(struct, data)
    if data.graphs is None or data.graphs["key"] != key:
        if any(t[-1] for t in key[-1]):
            return "eager", None
        data.graphs = {"key": key, "cycles": {}}  # the old graphs and their pools go
    cycles = data.graphs["cycles"]
    at = (b.shape, b.stride(), b.dtype, b.device)
    cyc = cycles.get(at)
    if cyc is None:
        cycles[at] = "warm"
        return "eager", None
    if cyc == "warm":
        return ("eager" if recording() else "capture"), at
    return "replay", cyc


def _capture(struct: PatchMGStructure, data: PatchMGData, b, at):
    """Capture one cycle of b's shape into a CUDA graph with a private
    memory pool, keep it under at, and replay it once for this call."""
    launches, by_lattice = dict(sk.launches), dict(sk.launches_by_lattice)
    static_b = torch.empty_like(b).copy_(b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(b.device), torch.cuda.graph(graph):
        x = _vcycle(struct, data, static_b)
    cyc = _CycleGraph(
        graph, static_b, x, {k: n - launches[k] for k, n in sk.launches.items() if n != launches[k]},
        {k: n - by_lattice.get(k, 0) for k, n in sk.launches_by_lattice.items() if n != by_lattice.get(k, 0)},
    )
    data.graphs["cycles"][at] = cyc
    graph.replay()
    return x.clone()


def _replay(cyc: _CycleGraph, b):
    cyc.b.copy_(b)
    cyc.graph.replay()
    for k, n in cyc.launches.items():
        sk.launches[k] += n
    for k, n in cyc.by_lattice.items():
        sk.launches_by_lattice[k] = sk.launches_by_lattice.get(k, 0) + n
    # a fresh tensor: a caller may hold the previous cycle's output (CG's
    # first search direction is its preconditioned residual)
    return cyc.x.clone()


def vcycle_p(struct: PatchMGStructure, data: PatchMGData, b, x0=None):
    """One V(pre,post)-cycle; b, x (C, *latf, P) consistent, free-masked,
    or (B, C, *latf, P): B independent cycles in one pass, each stencil
    apply one launch for all lanes.  Under struct.spmd, the restriction
    into the first agglomerated level gathers the additive residual once,
    the levels below run whole on every rank (the same arithmetic on
    each), and the prolongation takes the rank's block back.

    On a CUDA device a cycle from zero is one CUDA graph, replayed from
    the third call of a shape on (_graph_mode): the same launches in the
    same order, for one launch of the host.  The mg.vcycle span says which
    (its attribute graph: "eager", "capture" or "replay"); a replay
    records no span inside it and adds a cycle's launches to
    stencil_kernels' counts."""
    mode, got = _graph_mode(struct, data, b, x0)
    graph_counts[mode] += 1
    with span("mg.vcycle", graph=mode):
        if mode == "replay":
            return _replay(got, b)
        if mode == "capture":
            return _capture(struct, data, b, got)
        return _vcycle(struct, data, b, x0)


def make_preconditioner_p(struct: PatchMGStructure, data: PatchMGData):
    def M(r):
        return vcycle_p(struct, data, r)

    return M


def residual_df(struct: PatchMGStructure, data: PatchMGData, b, xh, xl):
    """r = b - A(xh+xl) as a double-float pair, error-free to O(eps^2):
    DF stencil apply (stencil_kernels.apply_w_df_sym) + error-free
    duplicate exchange (exchange_sum_df).  b is plain working precision."""
    ps = struct.ps
    tab = data.tabs[ps.k]
    with span("ir.residual"):
        yh, yl = st.apply_w_df(ps, data.W[ps.k], xh, xl)
        yh, yl = st.exchange_sum_df(tab, yh, yl, spmd=struct.spmd)
        free = tab.free[None].to(xh.dtype)
        # cancellation-safe DF subtraction: b - Ax cancels by construction
        r = df.add(df.from_f(b * free), df.DF(-yh * free, -yl * free))
        return r.hi, r.lo


class IRResult(NamedTuple):
    x_hi: torch.Tensor
    x_lo: torch.Tensor
    rounds: int
    inner_iters: int
    res_norm: torch.Tensor  # TRUE relative-to-b residual, DF-evaluated
    converged: bool


def cg_ir_p(
    struct: PatchMGStructure,
    data: PatchMGData,
    b,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_rounds: int = 8,
    inner_rel: float = 1e-4,
    inner_iters: int = 40,
) -> IRResult:
    """Mixed-precision MG solve to below-f32 residuals: double-float
    iterative refinement around the f32 MG-preconditioned CG.  x is carried
    as an unevaluated (hi, lo) pair; each round solves A e = r_hi in the
    working precision, updates x in DF and re-evaluates the defect with
    error-free transformations (residual_df)."""
    ps = struct.ps
    tab = data.tabs[ps.k]

    def dot(x, y):
        return st.owner_dot(None, x, y, tab, spmd=struct.spmd)

    bnorm = torch.sqrt(dot(b, b))
    tol = torch.clamp_min(rel_tol * bnorm, abs_tol)
    xh = torch.zeros_like(b)
    xl = torch.zeros_like(b)
    rh, rnorm, rounds, inner = b, bnorm, 0, 0
    while host_read(rnorm > tol) and rounds < max_rounds:
        with span("ir.round"):
            res = cg_p(struct, data, rh, max_iters=inner_iters, rel_tol=inner_rel, abs_tol=0.0)
            xh, xl = df.add(df.DF(xh, xl), df.from_f(res.x))
            rh, _ = residual_df(struct, data, b, xh, xl)
            rnorm = torch.sqrt(dot(rh, rh))
            rounds += 1
            inner += host_read(res.iters, int)
    return IRResult(xh, xl, rounds, inner, rnorm, host_read(rnorm <= tol))


def cg_p(
    struct: PatchMGStructure,
    data: PatchMGData,
    b,
    x0=None,
    max_iters: int = 60,
    abs_tol: float = 0.0,
    rel_tol: float = 1e-8,
):
    """MG-preconditioned CG on the fine patch level (owner-weighted inner
    products)."""
    ps = struct.ps
    tab = data.tabs[ps.k]
    return krylov.cg(
        lambda x: _apply(ps, tab, data.W[ps.k], x, struct.spmd),
        b,
        x0=x0,
        M=make_preconditioner_p(struct, data),
        max_iters=max_iters,
        abs_tol=abs_tol,
        rel_tol=rel_tol,
        dot=lambda x, y: st.owner_dot(None, x, y, tab, spmd=struct.spmd),
    )
