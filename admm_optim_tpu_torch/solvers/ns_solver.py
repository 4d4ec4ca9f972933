"""Newton solver for steady NS, the discrete adjoint and the shape gradient
(port of admm_optim_tpu/solvers/ns_solver.py, with the host-stepped
adjoint driver of models/obstacle.py:713-839).

Newton with the acceptBest backtracking line search; each linear solve is
flexible GMRES, stepped from the host in chunks of ``lin_exec_chunk``
Arnoldi steps with GCRO-DR recycling, on the assembled Jacobian (the
lattice one of ops.ns_patchjac or the per-element one of ops.ns_elljac) or
matrix-free: the forward-mode jvp of ns_residual in the state for Newton,
one reverse-mode vjp per adjoint solve whose closure every iteration
re-applies (residual_vjp).  The preconditioner is block triangular: for
the pressure, lumped pressure mass / nu (ns_gmg_M) or the PCD Schur
approximation Mp^-1 Fp Ap^-1 (ns_pcd_M: one scalar Jacobi V-cycle on the
pressure Laplacian, then the pressure convection-diffusion operator; on
the patch backend K5 at C = 1, on the global backend the ELL forms of
ns_pcd_precond_data); for the velocity, one Jacobi-smoothed conv-diff
V-cycle on the once-refined P1-iso-P2 lattice or space (K5 at C = 3 on the
patch backend), or on the NS level itself for P1/P1 velocity (vorder=1).
The coupling B^T is the assembled one, or without an assembled Jacobian
the affine pressure dependence of the residual (_bt_coupling).  The
adjoint solves J^T lambda = -dJ_drag/ds with the exact transpose of that
preconditioner, the autograd vjp through the V-cycles (K5^T).  The shape
gradient is the autograd gradient of J + lambda^T R in the coordinates;
shape_hvp differentiates it once more for the J'' term of b2nd_order.

On the global (block-ELL) backend the velocity block is one Jacobi V(2,2)
cycle of solvers.mg (ns_gmg_precond_data, ell_velocity_M) with the exact
transposed values per level, so that its autograd transpose replays
gathers only; the PCD Ap hierarchy and Fp carry theirs too.

Not ported: the monolithic jitted newton_solve / adjoint_solve (one
host-stepped solver each is kept).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import navier_stokes as nsops
from ..ops import patchstencil as pst
from ..ops import stencil_kernels as sk
from ..utils.profiling import host_read, span
from . import krylov
from . import patch_mg as pmg


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """The JAX package's NewtonConfig, every default unchanged (see its
    comments for the measurements behind them)."""

    max_iters: int = 50
    abs_tol: float = 1e-12
    # converged flag threshold: the inner GMRES tolerance bounds the
    # reachable Newton residual
    accept_tol: float = 1e-7
    line_search_steps: int = 20
    line_search_reduce: float = 0.9
    # FGMRES restart length, clamped by the basis memory budget
    lin_restart: int = 200
    lin_basis_budget_bytes: float = 4e9
    lin_max_iters: int = 600
    # inexact-Newton forcing term
    lin_rel_tol: float = 1e-2
    lin_abs_tol: float = 1e-14
    # the adjoint keeps a tight tolerance: J' inherits its linear residual
    adj_rel_tol: float = 1e-11
    # Arnoldi chunk of the adjoint (host reads the estimate after each)
    adj_exec_restart: int = 100
    # Arnoldi chunk of the forward linear solves
    lin_exec_chunk: int = 50
    # GCRO-DR recycle dimensions (0 disables)
    adj_recycle_k: int = 24
    lin_recycle_k: int = 16
    # stop Newton when an iteration reduces |R| by less than this fraction
    stall_rtol: float = 1e-3


def _restart_len(cfg: NewtonConfig, n_state: int, itemsize: int, mult: int = 1) -> int:
    """FGMRES restart length bounded by the basis memory budget (2*(restart
    +1) state vectors), at least 30."""
    cap = int(cfg.lin_basis_budget_bytes // max(2 * n_state * itemsize, 1)) - 1
    return max(30, min(mult * cfg.lin_restart, cap))


def _chunked_rl(cfg: NewtonConfig, n_state: int, itemsize: int) -> int:
    """Forward restart length rounded down to whole lin_exec_chunk chunks."""
    ch = max(1, int(cfg.lin_exec_chunk))
    return max(ch, (_restart_len(cfg, n_state, itemsize) // ch) * ch)


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


class NewtonResult(NamedTuple):
    s: torch.Tensor
    iters: int
    res_norm: float
    converged: bool
    res_history: list  # |R| at the start and after every Newton iteration
    lin_iters: list  # linear iterations per Newton iteration (chunk units)
    seconds: list  # wall seconds per Newton iteration, synchronized


# Jacobian and preconditioner applies of the Newton linear solves by how
# _Graphed ran them: eagerly, captured into a CUDA graph (and replayed
# once for the caller), or replayed from one
graph_counts = {"eager": 0, "capture": 0, "replay": 0}


class _Graphed:
    """fn(x) replayed from a CUDA graph.  A Newton iterate applies its
    Jacobian and its preconditioner to vectors of one shape hundreds of
    times on data fixed for the iterate; eagerly each apply is hundreds of
    launches from the host.  The first call of a shape runs eagerly (it
    makes the lazy tables and the library's handles), the second captures
    fn into a graph with a private memory pool and replays it, every later
    call copies x into the graph's static input and replays: the same
    kernels in the same order, one launch of the host.  CPU tensors, other
    shapes, inputs that require grad and calls inside another capture run
    eagerly.  A capture is one host.sync span (torch.cuda.graph
    synchronizes first); a replay adds the captured call's kernel launches
    to stencil_kernels' counts."""

    def __init__(self, fn):
        self.fn = fn
        self.at = None  # the (shape, dtype, device) of the first call
        self.graph = None

    def __call__(self, x):
        at = (x.shape, x.dtype, x.device)
        if not x.is_cuda or x.requires_grad or torch.cuda.is_current_stream_capturing() or (
                self.graph is not None and at != self.at):
            mode = "eager"
        elif self.graph is not None:
            mode = "replay"
        elif self.at != at:
            self.at, mode = at, "eager"
        else:
            mode = "capture"
        graph_counts[mode] += 1
        if mode == "eager":
            return self.fn(x)
        if mode == "capture":
            self._capture(x)
        else:
            self.x.copy_(x)
            for k, n in self.launches.items():
                sk.launches[k] += n
            for k, n in self.by_lattice.items():
                sk.launches_by_lattice[k] = sk.launches_by_lattice.get(k, 0) + n
        self.graph.replay()
        # a fresh tensor: the caller may keep it past the next apply
        return self.y.clone()

    def _capture(self, x):
        launches, by_lattice = dict(sk.launches), dict(sk.launches_by_lattice)
        self.x = x.clone()
        graph = torch.cuda.CUDAGraph()
        with span("host.sync"), torch.cuda.device(x.device), torch.cuda.graph(graph):
            self.y = self.fn(self.x)
        self.graph = graph
        self.launches = {k: n - launches[k] for k, n in sk.launches.items() if n != launches[k]}
        self.by_lattice = {k: n - by_lattice.get(k, 0) for k, n in sk.launches_by_lattice.items()
                           if n != by_lattice.get(k, 0)}


def newton_solve_stepped(
    space, coords, s0, visc, stab, cfg: NewtonConfig, M_fn=None, jv_fn=None, pre_fn=None,
    recycle: dict | None = None, graphs: bool = False,
) -> NewtonResult:
    """Host-stepped Newton with the acceptBest line search.

    pre_fn(s) -> m_args builds the per-iterate data; M_fn(r, *m_args) is
    the preconditioner (default: nsops.diag_preconditioner at coords) and
    jv_fn(x, W) the Jacobian apply with W the last element of m_args (the
    JAX package's jv_from_m wiring); without jv_fn the apply is matrix-free,
    the jvp of ns_residual at the iterate.  Each linear solve runs FGMRES
    cycles of _chunked_rl steps, reading the residual estimate after every
    lin_exec_chunk steps, with GCRO-DR recycling carried across Newton
    iterates.  recycle is the caller's dict that carries the recycle space
    further, across continuation rungs and optimization steps: its "U"
    seeds the first iterate (re-imaged against that iterate's Jacobian at
    the cost of lin_recycle_k applies) and is replaced by the space the
    last iterate left.  graphs: each iterate's Jacobian and preconditioner
    applies replay CUDA graphs (_Graphed), which jv_fn and M_fn must allow:
    no host reads, tensors made in the call or kept by reference.

    Spans (recorded only while a profiler records): ns.iterate per Newton
    iterate, holding ns.krylov (its linear solve, whose preconditioner
    applies are ns.precond spans) and ns.line_search; every blocking read
    is a host.sync."""

    def R(ss):
        return nsops.ns_residual(space, coords, ss, visc, stab)

    M_diag = nsops.diag_preconditioner(space, coords, visc) if M_fn is None else None

    def wiring(s, m_args):
        if jv_fn is not None:
            W = m_args[-1]
            Jv = lambda x: jv_fn(x, W)  # noqa: E731
        else:
            Jv = lambda x: torch.func.jvp(R, (s,), (x,))[1]  # noqa: E731
        M = M_diag if M_fn is None else (lambda x: M_fn(x, *m_args))  # noqa: E731
        if graphs:
            Jv, M = _Graphed(Jv), _Graphed(M)

        def Mx(x):
            with span("ns.precond"):
                return M(x)

        return Jv, Mx

    n, isz = s0.numel(), s0.element_size()
    rl = _chunked_rl(cfg, n, isz)
    ch = min(max(1, int(cfg.lin_exec_chunk)), rl)
    nrm = host_read(_norm(R(s0)), float)
    hist, lin_hist, secs = [nrm], [], []
    s, it = s0, 0
    k_r = max(0, int(cfg.lin_recycle_k))
    if rl < 8 * k_r:
        # harmonic Ritz directions of short cycles are noise
        k_r = 0
    U_carry = recycle.get("U") if recycle is not None else None
    while nrm > cfg.abs_tol and it < cfg.max_iters:
        with span("ns.iterate"):
            t0 = time.perf_counter()
            Jv, Mx = wiring(s, pre_fn(s) if pre_fn is not None else ())
            b = -R(s)
            # inexact-Newton target fixed from this iterate's residual
            target = max(cfg.lin_abs_tol, 0.1 * cfg.accept_tol, cfg.lin_rel_tol * nrm)
            with span("ns.krylov"):
                x, lin_its, U = _linear_solve(Jv, Mx, b, target, cfg, rl, ch, k_r, U_carry)
            if U is not None:
                U_carry = U
            with span("ns.line_search"):
                s_new, nrm_new = _line_search(R, cfg, s, x, nrm)
            stalled = nrm_new >= nrm * (1.0 - cfg.stall_rtol)
            s, nrm = s_new, nrm_new
            it += 1
            hist.append(nrm)
            lin_hist.append(lin_its)
            secs.append(time.perf_counter() - t0)
        if stalled:
            break
    if recycle is not None:
        recycle["U"] = U_carry
    return NewtonResult(s, it, nrm, nrm <= cfg.accept_tol, hist, lin_hist, secs)


def _linear_solve(Jv, Mx, b, target: float, cfg: NewtonConfig, rl: int, ch: int, k_r: int, U_carry):
    """One Newton iterate's FGMRES solve of Jv x = b from zero, in cycles of
    rl Arnoldi steps read every ch steps, deflated by the recycle space
    U_carry (re-imaged first, k_r applies) when it has rank k_r.  Returns
    (x, linear iterations, the recycle space it leaves or None)."""
    x = torch.zeros_like(b)
    lin_its = 0
    beta_prev = None
    U = C = None
    if k_r > 0 and U_carry is not None and U_carry.shape[0] == k_r:
        # re-image the recycle space against this iterate's Jacobian
        # (k plain applies, charged to the linear budget)
        U, C = krylov.gcro_prepare(Jv, U_carry)
        lin_its += k_r
    while lin_its < cfg.lin_max_iters:
        if U is not None:
            x_p, V, Z, H, B, beta = krylov.gcro_chunk_start(Jv, b, x, U, C, rl)
        else:
            V, Z, H, beta = krylov.gmres_chunk_start(Jv, b, x, rl)
            B, x_p = None, x
        bf = host_read(beta, float)
        if bf <= target:
            x = x_p
            break
        if beta_prev is not None and not (bf < beta_prev * (1.0 - 1e-6)):
            # restart cycle stagnated (f32 floor)
            x = x_p
            break
        beta_prev = bf
        x = x_p
        j, est = 0, bf
        while j < rl and est > target and lin_its < cfg.lin_max_iters:
            if U is not None:
                V, Z, H, B, est = krylov.gcro_chunk_arnoldi(Jv, Mx, C, V, Z, H, B, beta, j, ch)
            else:
                V, Z, H, est = krylov.gmres_chunk_arnoldi(Jv, Mx, V, Z, H, beta, j, ch)
            j += ch
            lin_its += ch
        if U is not None:
            x = krylov.gcro_chunk_finish(x, Z, H, B, beta, U, j)
        else:
            x = krylov.gmres_chunk_finish(x, Z, H, beta, j)
        if k_r > 0:
            Un, Cn = krylov.gcro_update_recycle(U, C, V, Z, H, B, k_r, j)
            if Un.shape[0] == k_r:
                U, C = Un, Cn
        del V, Z, H, B
    return x, lin_its, U


def _line_search(R, cfg: NewtonConfig, s, delta, nrm: float):
    """acceptBest backtracking: try lambda = reduce^k for every k, keep the
    best.  One host sync, at the end (nrm enters the comparisons as a
    scalar, rounded to s's dtype, not as a tensor copied to the device)."""
    best_s, best = s, nrm
    for k in range(cfg.line_search_steps):
        s_try = s + cfg.line_search_reduce**k * delta
        nrm_t = _norm(R(s_try))
        better = nrm_t < best
        best_s = torch.where(better, s_try, best_s)
        best = torch.where(better, nrm_t, best)
    return best_s, host_read(best, float)


def drag_gradient(space, coords, s, visc):
    """dJ_drag/ds by autograd."""
    sg = s.detach().requires_grad_(True)
    with torch.enable_grad():
        J = nsops.drag(space, coords, sg, visc)
        return torch.autograd.grad(J, sg)[0]


def shape_gradient(space, coords, s, lam, visc, stab, obstacle_vmask):
    """J'(X) = d/dX [J_drag + lambda^T R] at fixed (s, lambda), masked to
    the obstacle surface: (V, d)."""
    X = coords.detach().requires_grad_(True)
    s, lam = s.detach(), lam.detach()
    with torch.enable_grad():
        L = nsops.drag(space, X, s, visc) + torch.sum(lam * nsops.ns_residual(space, X, s, visc, stab))
        g = torch.autograd.grad(L, X)[0]
    return g * obstacle_vmask[:, None]


def shape_hvp(space, coords, s, lam, visc, stab, obstacle_vmask):
    """v (V, d) -> the directional derivative of shape_gradient in X along
    v at fixed (s, lambda): the Hessian of L = J_drag + lambda^T R in X
    applied to v, masked to the obstacle surface (the J'' term of
    b2nd_order; the JAX package's jax.jvp of the frozen J').  The gradient
    of L is recorded once with its graph; each call differentiates
    <grad L, v> again (the Hessian of a scalar is symmetric, so this
    reverse-over-reverse product is the jvp)."""
    X = coords.detach().requires_grad_(True)
    s, lam = s.detach(), lam.detach()
    with torch.enable_grad():
        L = nsops.drag(space, X, s, visc) + torch.sum(lam * nsops.ns_residual(space, X, s, visc, stab))
        g = torch.autograd.grad(L, X, create_graph=True)[0]

    def hvp(v):
        with torch.enable_grad():
            return torch.autograd.grad(g, X, v, retain_graph=True)[0] * obstacle_vmask[:, None]

    return hvp


def residual_vjp(space, coords, s, visc, stab):
    """x -> J(s)^T x, the matrix-free transpose: one reverse-mode vjp of
    ns_residual at s, whose closure (the residual's saved tensors) every
    call re-applies."""
    _, vjp = torch.func.vjp(lambda ss: nsops.ns_residual(space, coords, ss, visc, stab), s.detach())
    return lambda x: vjp(x)[0]


class AdjointResult(NamedTuple):
    lam: torch.Tensor
    res_norm: float  # true residual norm where the loop stopped
    iters: int  # Arnoldi steps in chunk units, plus the recycle re-images
    exit: str  # "target", "stagnation" or "budget"
    target: float
    cycles: int


def adjoint_solve_stepped(
    space, coords, s, visc, Jt: Callable | None = None, MT: Callable | None = None,
    cfg: NewtonConfig = NewtonConfig(), lam0=None, recycle: dict | None = None, stab: float = 0.0,
) -> AdjointResult:
    """J^T lambda = -dJ_drag/ds by host-stepped FGMRES with GCRO-DR (the
    JAX package's models/obstacle.py _adjoint_stepped).

    The target is max(lin_abs_tol, adj_rel_tol * |dJ/ds|); the restart is
    the budgeted _restart_len(mult=2) rounded down to whole adj_exec_restart
    chunks; the budget is 4 * lin_max_iters.  A cycle whose starting
    residual does not drop below (1 - 1e-6) times the previous one stops
    the loop (the float32 stagnation exit).  The warm start across
    optimization steps: lam0 is the first iterate (default 0), and
    recycle is the caller's dict that carries the recycle space: a "U" of
    the full rank adj_recycle_k is re-imaged against this Jt first (k
    applies, charged to the budget), and the space the solve leaves is put
    back under "U".  Without Jt the apply is matrix-free (residual_vjp
    at s, with stab); without MT the preconditioner is the symmetric
    nsops.diag_preconditioner (the JAX package's adjoint_solve defaults)."""
    if Jt is None:
        Jt = residual_vjp(space, coords, s, visc, stab)
    if MT is None:
        MT = nsops.diag_preconditioner(space, coords, visc)
    gJ = drag_gradient(space, coords, s, visc)
    b = -gJ
    target = max(cfg.lin_abs_tol, cfg.adj_rel_tol * float(_norm(gJ)))
    ch = max(1, int(cfg.adj_exec_restart))
    rl_full = _restart_len(cfg, s.numel(), s.element_size(), mult=2)
    rl = max(ch, (rl_full // ch) * ch)
    budget = 4 * cfg.lin_max_iters
    x = torch.zeros_like(s) if lam0 is None else lam0
    total, cycles = 0, 0
    beta_prev = None
    k_r = max(0, int(cfg.adj_recycle_k))
    if rl < 8 * k_r:
        # harmonic Ritz directions of short cycles are noise
        k_r = 0
    U = C = None
    U_carry = recycle.get("U") if recycle is not None else None
    if k_r > 0 and U_carry is not None and U_carry.shape[0] == k_r:
        U, C = krylov.gcro_prepare(Jt, U_carry)
        total += k_r
    exit_ = "budget"
    while True:
        if U is not None:
            x_p, V, Z, H, B, beta = krylov.gcro_chunk_start(Jt, b, x, U, C, rl)
        else:
            V, Z, H, beta = krylov.gmres_chunk_start(Jt, b, x, rl)
            B, x_p = None, x
        bf = float(beta)
        if bf <= target or total >= budget:
            x = x_p
            exit_ = "target" if bf <= target else "budget"
            break
        if beta_prev is not None and not (bf < beta_prev * (1.0 - 1e-6)):
            x = x_p
            exit_ = "stagnation"
            break
        beta_prev = bf
        x = x_p
        j, est = 0, bf
        while j < rl and est > target and total < budget:
            if U is not None:
                V, Z, H, B, est = krylov.gcro_chunk_arnoldi(Jt, MT, C, V, Z, H, B, beta, j, ch)
            else:
                V, Z, H, est = krylov.gmres_chunk_arnoldi(Jt, MT, V, Z, H, beta, j, ch)
            j += ch
            total += ch
        if U is not None:
            x = krylov.gcro_chunk_finish(x, Z, H, B, beta, U, j)
        else:
            x = krylov.gmres_chunk_finish(x, Z, H, beta, j)
        cycles += 1
        if k_r > 0:
            Un, Cn = krylov.gcro_update_recycle(U, C, V, Z, H, B, k_r, j)
            if Un.shape[0] == k_r:
                U, C = Un, Cn
        del V, Z, H, B
    if recycle is not None and k_r > 0 and U is not None:
        recycle["U"] = U
    return AdjointResult(x, bf, total, exit_, target, cycles)


# ---------------------------------------------------------------------------
# block preconditioner on the patch backend
# ---------------------------------------------------------------------------

def ns_gmg_precond_data_patch(
    ns_space, pre_ps, pre_struct_p, pre_tabs, base_dense_fn, parents_fine, coords, visc, s,
    adjoint: bool = False, p2_iso: bool = True,
):
    """Velocity-block conv-diff hierarchy on the once-refined lattice and
    the pressure block's lumped mass / nu.

    The P2 velocity dofs of level L are the vertices of level L+1, so the
    current velocity is the P1 advecting field of every level's operator;
    geometry and velocity travel together as the stacked [coords | w]
    lattice array.  base_dense_fn receives that array at level 0, (V0, 2d).
    p2_iso=False is the P1/P1 velocity (vorder=1): the lattice is the NS
    level's own and parents_fine is not used.  adjoint negates the
    advecting field (kept for parity; the adjoint solve transposes the
    forward preconditioner instead).  Returns (pre_data, pdiag)."""
    from ..ops.convdiff import convdiff_corner_mats

    Xf = 0.5 * (coords[parents_fine[:, 0]] + coords[parents_fine[:, 1]]) if p2_iso else coords
    w, _ = ns_space.unpack(s)
    w = -w if adjoint else w
    cw_p = pst.to_patch_tab(pre_tabs[-1], torch.cat([Xf.T, w], dim=0))
    pre_data = pmg.assemble_patch_mg_p(
        pre_ps, pre_struct_p, cw_p, lambda c: convdiff_corner_mats(c, visc), base_dense_fn, pre_tabs,
    )
    return pre_data, nsops.pressure_mass_lumped(ns_space, coords, visc)


def ns_gmg_precond_data(ns_space, pre_space, pre_struct, coords, visc, s, adjoint: bool = False,
                        with_transpose: bool = False, p2_iso: bool = True):
    """Global-backend velocity-block data: the conv-diff hierarchy of
    pre_space (the P1 space over levels 0..L+1, whose level L+1 vertices
    are the P2 velocity dofs of level L, so the velocity is the advecting
    P1 field) at the once-refined coordinates, and the pressure block's
    lumped mass / nu.  p2_iso=False: P1/P1 velocity (vorder=1), pre_space
    over the NS levels themselves at coords.  with_transpose stores each
    level's transposed values (the adjoint's transposed cycle stays a
    gather).  Returns (pre_data, pdiag)."""
    if p2_iso:
        p = pre_space.parents[-1].parents_t(coords.device)
        Xf = 0.5 * (coords[p[:, 0]] + coords[p[:, 1]])
    else:
        Xf = coords
    w, _ = ns_space.unpack(s)
    w = -w if adjoint else w
    pre_data = pre_space.assemble_mg_convdiff(pre_struct, Xf, w, visc, with_transpose=with_transpose)
    return pre_data, nsops.pressure_mass_lumped(ns_space, coords, visc)


def ell_velocity_M(pre_struct, pre_data):
    """Velocity-block action zv ~= F^-1 rv on the global backend, (d, n_vel)
    in and out: one V-cycle of solvers.mg (the JAX package's ns_gmg_M with
    vel_M=None)."""
    from . import mg

    def zv_fn(rv):
        return mg.vcycle(pre_struct, pre_data, rv.reshape(-1)).reshape(rv.shape)

    return zv_fn


def patch_velocity_M(pre_ps, pre_struct_p, pre_data, iters: int = 1):
    """Velocity-block action zv ~= F^-1 rv, global (d, n_vel) in and out:
    one V-cycle (iters > 1: V-cycle-preconditioned Richardson).  Fixed
    (Dirichlet) dofs pass through untouched."""
    tab = pre_data.tabs[pre_ps.k]
    W = pre_data.W[-1]

    def zv_fn(rv):
        free = tab.free[None].to(rv.dtype)
        b_p = pst.to_patch_tab(tab, rv)
        bf = b_p * free
        z_p = pmg.vcycle_p(pre_struct_p, pre_data, bf)
        for _ in range(iters - 1):
            Az = pmg._apply(pre_ps, tab, W, z_p)
            z_p = z_p + pmg.vcycle_p(pre_struct_p, pre_data, (bf - Az) * free)
        z_p = z_p + b_p * (1.0 - free)
        return pst.from_patch_tab(tab, z_p, rv.shape[1], mode="owner")

    return zv_fn


def _bt_coupling(ns_space, coords, visc, stab, like):
    """The off-diagonal actions from the affine structure of the residual,
    each one residual evaluation: bt(zp) = B^T zp = R_mom(0, zp) -
    R_mom(0, 0), (n_p,) -> (d, n_vel), and b(zv) = B zv = R_div(zv, 0) -
    R_div(0, 0).  Exact for any visc (the coupling blocks do not depend on
    it); the Dirichlet rows cancel in the difference.  like gives the
    dtype."""
    zero_v = torch.zeros((ns_space.dim, ns_space.n_vel), dtype=like.dtype, device=coords.device)
    zero_p = torch.zeros((ns_space.n_pressure,), dtype=like.dtype, device=coords.device)
    r_zero = nsops.ns_residual(ns_space, coords, ns_space.pack(zero_v, zero_p), visc, stab)

    def bt(zp):
        out, _ = ns_space.unpack(nsops.ns_residual(ns_space, coords, ns_space.pack(zero_v, zp), visc, stab) - r_zero)
        return out

    def b(zv):
        _, out = ns_space.unpack(nsops.ns_residual(ns_space, coords, ns_space.pack(zv, zero_p), visc, stab) - r_zero)
        return out

    return bt, b


def _coupling(ns_space, bt_fn, coords, visc, stab):
    """bt_fn, or without it _bt_coupling's B^T when coords and visc are
    given (the triangular form), else None (block diagonal)."""
    if bt_fn is not None or coords is None or visc is None:
        return bt_fn
    return _bt_coupling(ns_space, coords, visc, stab, coords)[0]


def ns_gmg_M(ns_space, pdiag, vel_M, bt_fn=None, coords=None, visc=None, stab: float = 0.0):
    """Block preconditioner: z_p = r_p / pdiag, then z_v = vel_M(r_v -
    B^T z_p).  Block triangular with bt_fn (the assembled B^T of
    ops.ns_patchjac / ns_elljac.make_bt_fn) or, without it, with coords
    and visc given, the B^T of _bt_coupling (one residual evaluation per
    application); block diagonal otherwise."""
    bt = _coupling(ns_space, bt_fn, coords, visc, stab)

    def M(r):
        rv, rp = ns_space.unpack(r)
        zp = rp / pdiag
        if bt is not None:
            rv = rv - bt(zp)
        return ns_space.pack(vel_M(rv), zp)

    return M


# ---------------------------------------------------------------------------
# PCD (pressure convection-diffusion) Schur block on the patch backend
# ---------------------------------------------------------------------------

def pcd_patch_tables(hier, ps, dtype=torch.float32, device="cpu"):
    """Level tables of the scalar pressure space on the level-k patchset,
    with the PCD inlet-Dirichlet free masks (Kay-Loghin-Wathen with
    Dirichlet rows where the flow enters, the JAX package's ns_pcd_spaces)
    in place of the patchset's own.  Exchange and ownership tables do not
    depend on the Dirichlet set, so only ``free`` is rebuilt, from the
    level's global ids."""
    tabs = pmg.make_level_tables(ps, dtype, device)
    out = []
    for l, lvl in enumerate(ps.levels):
        fixed = hier.levels[l].vertex_mask(("inlet",))
        # contiguous like make_tables' own mask: elementwise results take its
        # strides, and the kernel wrappers refuse strided fields
        free = np.ascontiguousarray(np.moveaxis(~fixed[np.asarray(lvl.gid)], 0, -1))
        out.append(dataclasses.replace(tabs[l], free=torch.as_tensor(free, dtype=dtype, device=device)))
    return out


def ns_pcd_precond_data_patch(
    ns_space, ps, p_struct_p, p_tabs, ap_base_dense_fn, coords, visc, s=None, adjoint: bool = False,
):
    """PCD Schur data on the level-k lattice (the pressure P1 dofs are its
    sites): the unit-viscosity pressure-Laplacian hierarchy Ap (w = 0, so
    the artificial diffusion adds nothing), the fine-level plain Galerkin
    pressure convection-diffusion stencil Fp at the frozen velocity and at
    ``visc``, and the lumped pressure mass Mp (not nu-scaled: Fp carries
    the physics).  All stencils are full 15-slot scalar ones, C = 1.
    Returns (ap_data, W_fp, mp)."""
    from ..ops.convdiff import convdiff_corner_mats

    d = ns_space.dim
    if s is None:
        w = coords.new_zeros((d, ns_space.n_vel))
    else:
        w, _ = ns_space.unpack(s)
        w = -w if adjoint else w
    # P2 nodal coefficients are interpolatory and the vertex dofs come first
    w_p1 = w[:, : ns_space.n_vertices]
    tab = p_tabs[-1]
    cw_ap = torch.cat([coords.T, torch.zeros_like(w_p1)], dim=0)
    ap_data = pmg.assemble_patch_mg_p(
        ps, p_struct_p, pst.to_patch_tab(tab, cw_ap),
        lambda c: convdiff_corner_mats(c, 1.0, ncomp=1), ap_base_dense_fn, p_tabs,
    )
    cw_fp = torch.cat([coords.T, w_p1], dim=0)
    W_fp = pst.assemble_w(
        ps, ps.k, pst.to_patch_tab(tab, cw_fp),
        lambda c: convdiff_corner_mats(c, visc, art_diff=False, ncomp=1),
        free=tab.free.to(coords.dtype),
    )
    mp = torch.clamp_min(nsops.pressure_mass_lumped(ns_space, coords, 1.0), 1e-30)
    return ap_data, W_fp, mp


def pcd_schur_patch_M(ns_space, ps, p_struct_p, p_tabs, ap_data, W_fp, mp):
    """S^-1 ~= Mp^-1 Fp Ap^-1 on the patch backend, global (n_p,) in and
    out.  The Dirichlet rows of Ap and Fp are identity rows: the PCD inlet
    constraint exists only inside the Schur surrogate (the true pressure
    rows are divergence rows), so the fixed components pass through both
    operators instead of vanishing; a zeroed subspace would make the
    preconditioner singular there."""
    tab = p_tabs[-1]

    def S_inv(rp):
        rp_p = pst.to_patch_tab(tab, rp[None])
        free = tab.free[None].to(rp_p.dtype)
        yp = pmg.vcycle_p(p_struct_p, ap_data, rp_p * free) + rp_p * (1.0 - free)
        z = pst.exchange_sum(None, pst.apply_w(ps, W_fp, yp), tab)
        z = z + yp * (1.0 - free)
        zp = pst.from_patch_tab(tab, z, ns_space.n_pressure, mode="owner")
        return zp[0] / mp

    return S_inv


def ns_pcd_spaces(hier, do_nothing: bool = True):
    """The scalar pressure space of the global-backend PCD block: P1 on
    the NS levels (Taylor-Hood pressure), inlet-Dirichlet (Kay-Loghin-Wathen
    with Dirichlet rows where the flow enters, measured best by the JAX
    package on the channel), and its Jacobi V(2,2) structure.
    do_nothing is accepted for parity; the Dirichlet set does not depend
    on it.  Returns (p_space, p_struct)."""
    from ..ops.p1space import P1VectorSpace

    p_space = P1VectorSpace.build(hier, dirichlet=("inlet",), ncomp=1)
    p_struct = dataclasses.replace(p_space.mg_structure(pre_smooth=2, post_smooth=2), smoother="jacobi")
    return p_space, p_struct


def ns_pcd_precond_data(ns_space, p_space, p_struct, coords, visc, s=None, adjoint: bool = False,
                        with_transpose: bool = False):
    """PCD Schur data on the global backend: the unit-viscosity pressure
    Laplacian hierarchy Ap (w = 0, so the artificial diffusion adds
    nothing), the fine-level plain Galerkin pressure convection-diffusion
    operator Fp at the frozen velocity and at visc, baked inlet-Dirichlet,
    and the lumped pressure mass Mp (not nu-scaled: Fp carries the
    physics), summed by the NS space's fixed-order vertex plan.
    with_transpose stores the transposed values of every Ap level and of
    Fp, so that transpose_M's replay of the Schur block is gathers only.
    Returns (ap_data, fp_vals, mp, fp_vals_t), fp_vals_t None without
    with_transpose (the JAX package returns the first three)."""
    from ..ops import sparsity
    from ..ops.convdiff import convdiff_elem_mats

    d = ns_space.dim
    if s is None:
        w = coords.new_zeros((d, ns_space.n_vel))
    else:
        w, _ = ns_space.unpack(s)
        w = -w if adjoint else w
    # P2 nodal coefficients are interpolatory and the vertex dofs come first
    w_p1 = w[:, : ns_space.n_vertices]
    ap_data = p_space.assemble_mg_convdiff(p_struct, coords, torch.zeros_like(w_p1), 1.0,
                                           with_transpose=with_transpose)
    pat = p_space.fine_pattern
    elems, fixed = p_space.level_tensors(len(p_space.patterns) - 1, coords.device)
    em = convdiff_elem_mats(coords, elems, w_p1, visc, art_diff=False, ncomp=1)
    fp_vals = sparsity.bake_dirichlet(pat, sparsity.assemble_values(pat, em), fixed)
    fp_vals_t = sparsity.transpose_values(pat, fp_vals, p_space.transpose_maps()[-1]) if with_transpose else None
    mp = torch.clamp_min(nsops.pressure_mass_lumped(ns_space, coords, 1.0), 1e-30)
    return ap_data, fp_vals, mp, fp_vals_t


def pcd_schur_ell_M(p_space, p_struct, ap_data, fp_vals, mp, fp_vals_t=None):
    """S^-1 ~= Mp^-1 Fp Ap^-1 on the global backend, (n_p,) in and out: one
    scalar V-cycle of solvers.mg on Ap, then the ELL Fp (with its
    transposed values a spmv_flat_pair, whose backward is a gather)."""
    from ..ops import sparsity
    from . import mg

    pat = p_space.fine_pattern

    def S_inv(rp):
        yp = mg.vcycle(p_struct, ap_data, rp)
        if fp_vals_t is None:
            return sparsity.spmv_flat(pat, fp_vals, yp) / mp
        return sparsity.spmv_flat_pair(pat, fp_vals, fp_vals_t, yp) / mp

    return S_inv


def ns_pcd_M(ns_space, schur_fn, vel_M, bt_fn=None, coords=None, visc=None, stab: float = 0.0):
    """Block-triangular preconditioner with the PCD Schur approximation:
    z_p = schur_fn(r_p) = Mp^-1 Fp Ap^-1 r_p (pcd_schur_patch_M or
    pcd_schur_ell_M), then z_v = vel_M(r_v - B^T z_p) (one conv-diff
    V-cycle), with bt_fn the assembled B^T or, without it, with coords and
    visc given, _bt_coupling's; block diagonal otherwise, which stalls GMRES
    at low viscosity (the JAX package's measurement)."""
    bt = _coupling(ns_space, bt_fn, coords, visc, stab)

    def M(r):
        rv, rp = ns_space.unpack(r)
        zp = schur_fn(rp)
        if bt is not None:
            rv = rv - bt(zp)
        return ns_space.pack(vel_M(rv), zp)

    return M


def transpose_M(M, n_state, dtype, device):
    """The exact transpose of a linear preconditioner: the vector-Jacobian
    product of M at zero, recorded once; each call of the result runs the
    recorded backward (K5^T through the velocity V-cycle).  The adjoint
    reproduces the forward solve's Krylov convergence with it (eig(J^T
    M^T) = eig(M J)).  Plain autograd rather than torch.func.vjp: under
    torch.func the tensors that a custom Function saves come back wrapped,
    without the storage a kernel launch needs."""
    x0 = torch.zeros(n_state, dtype=dtype, device=device, requires_grad=True)
    with torch.enable_grad():
        y = M(x0)

    def MT(r):
        return torch.autograd.grad(y, x0, r, retain_graph=True)[0]

    return MT
