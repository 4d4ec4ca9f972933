"""The ADMM inner solver (port of admm_optim_tpu/optim/admm.py): x-update
Newton with Schur-complement constraint handling, z-update prox, dual
ascent, and the sigma/scaling adaptation, as host loops.

Reference parity map (2d_admm.lua):
 * ADMM loop            -> admm_inner (2d:868-1253)
 * z-update + projection-> ops_.z_update (2d:883-905)
 * x-update Newton      -> newton_xupdate_ops (2d:926-1171): per iteration
     - L_u = A u + r_lin + Lambda^T dg/du;   H = A + Lambda^T d2g/du2
     - solve H st = L_u and H t_i = B_i, B_i = dg_i/du: ONE batched Krylov
       solve over the 1+m lanes (the JAX package's jax.vmap)
     - S_ij = B_i . t_j ;  DLambda = S^-1 (g - B^T st)
     - Du = -st - sum_j DLambda_j t_j
     - convergence on |DLambda| / abs / rel defect norms (2d:1163-1169)
 * -b2ndOrder           -> extra_hvp (2d:86, 389-419): the J'' term joins
     the x-update operator and its defect L_u; the matvec is then
     A x + Lambda^T g'' x + J'' x lane by lane, not the assembled hess_fn
 * dual ascent          -> ops_.dual_update (2d:1181-1185)
 * convergence + "fake convergence" scaling*=2 restart (2d:1226-1250)

The JAX package's ``lax.while_loop``s become Python loops with Python
counters; its monolithic and host-stepped drivers (held equal by its own
tests) become the one driver ``admm_inner``.  ``xsolve_sequential`` runs
the 1+m x-update solves one lane at a time, as its ``lax.map`` does.

On a sharded PatchOps (parallel.patch_shard) each rank runs these loops on
its patch block: every value a loop decides on (the Krylov residuals, the
constraint defects, the Newton and ADMM norms, the gradient maximum) comes
from the adapter's all-reduced dots and norms, the same bits on every
rank, so the ranks take the same branches and reach the same collectives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..solvers import krylov
from ..utils.profiling import host_read, span


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Knobs, named after the reference CLI flags (2d_admm.lua:43-87)."""

    admm_steps: int = 100  # -admmSteps
    admm_tolerance: float = 1e-2  # -admm_tolerance
    admm_gradient_tolerance: float = 0.05  # -admm_gradient_tolerance
    tau: float = 1.0  # -tau
    sigma_threshold: float = 0.3  # -sigma_threshold
    scaling: float = 1.0  # -scaling
    step_length: float = 1.0  # -step_length
    norm_name: str = "frobenius"  # -normName
    ns_max_its: int = 10  # -nsMaxIts (x-update Newton)
    ns_tol: float = 1e-9  # -nsTol (on |DeltaLambda|)
    ns_abs_tol: float = 1e-12  # -nsAbsLuTol (on |Lu|)
    ns_abs_llambda_tol: float = 1e-12  # -nsAbsLlambdaTol (on |g|)
    ns_rel_tol: float = 1e-12  # -nsRelLuTol (on |Lu|/|Lu_0|)
    ns_rel_llambda_tol: float = 1e-12  # -nsRelLlambdaTol (on |g|/|g_0|)
    # -lambda_vol/-lambda_x/-lambda_y[/-lambda_z]: warm start for the
    # geometric multipliers of each x-update Newton solve; empty = zeros
    lambda_init: tuple = ()
    # ADMM over-relaxation alpha (Boyd et al. sec. 3.4.3); 1.0 = reference
    relax_alpha: float = 1.0
    lin_max_iters: int = 200
    lin_abs_tol: float = 1e-12
    lin_rel_tol: float = 1e-10
    # run the x-update's 1+m Krylov solves one lane at a time through the
    # same solver instead of as one lane-batched solve (the JAX package's
    # lax.map against its vmap); each lane takes the same loop either way,
    # and one at a time the solve holds one lane's working set
    xsolve_sequential: bool = False
    # Krylov method for the x-update H-solves: "bicgstab" (the reference's
    # preset) or "cg" (H is symmetric; one apply + one V-cycle per
    # iteration against BiCGStab's two of each)
    x_solver: str = "bicgstab"
    # stagnation acceptance for the x-update Krylov solves (f32 path): a
    # solve that misses lin_abs/rel_tol but reaches a relative residual
    # <= lin_accept_rel is still OK.  0 = strict (the reference's ConvCheck)
    lin_accept_rel: float = 0.0
    c_eps: float = 1.0  # extension operator eps(u):eps(w) weight
    c_mass: float = 1.0  # extension operator u.w weight


def _lambda_init(cfg: ADMMConfig, m: int, dtype, device) -> torch.Tensor:
    """Initial geometric multipliers (m,) from cfg.lambda_init (zeros if unset)."""
    if not cfg.lambda_init:
        return torch.zeros(m, dtype=dtype, device=device)
    if len(cfg.lambda_init) != m:
        raise ValueError(
            f"lambda_init has {len(cfg.lambda_init)} entries, problem has m={m} constraints"
        )
    return torch.tensor(cfg.lambda_init, dtype=dtype, device=device)


@dataclasses.dataclass
class ADMMState:
    """State of the ADMM loop: fields on the device, counters and norms on
    the host."""

    u: torch.Tensor  # (C, *lat, P) deformation iterate
    u_old: torch.Tensor  # previous ADMM iterate (for u_diff / max-norm)
    lam: torch.Tensor  # (d, d, T, *cells, P) piecewise-constant dual tensor
    q_proj: torch.Tensor  # projected gradient copy, as lam
    Lambda: torch.Tensor  # (m,) geometric-constraint multipliers
    scaling: float  # J' scaling (adapted on fake convergence)
    admm_it: int
    total_newton: int  # accumulated Newton iterations
    total_lin_iters: int  # accumulated Krylov iterations
    # accumulated Krylov iterations per solve slot [rhs, B_vol, B_x, B_y(, B_z)]
    solver_iters: list
    converged: bool
    failed: bool  # solver failure / max steps
    u_diff_norm: float
    lam_inc_norm: float
    max_grad_norm: float
    # (admm_steps, 6) float64 on the host, row min(admm_it, admm_steps-1) of
    # each iteration: [scaling, sigma, u_diff, lam_inc, max_grad, sigma - max_grad]
    stats: torch.Tensor
    # the last x-update's Newton failed: a Krylov solve failed, or ns_max_its
    # passed short of the tolerances (with admm_tolerance 0 the loop ends
    # failed at admm_steps all the same, so this tells a sound fixed-depth
    # loop from a broken one)
    newton_failed: bool = False
    # accumulated batched Krylov iterations: per x-update solve the most any
    # of its 1+m lanes took, which a lane-batched solve runs for every lane
    batch_iters: int = 0


def initial_state(cfg: ADMMConfig, ops_, scaling, dtype) -> ADMMState:
    """The state admm_inner starts from: zero fields, Lambda from
    cfg.lambda_init."""
    zf = ops_.zeros_field(dtype)
    zt = ops_.zeros_tensor(dtype)
    m = 1 + ops_.dim
    return ADMMState(
        u=zf, u_old=zf, lam=zt, q_proj=zt,
        Lambda=_lambda_init(cfg, m, dtype, zf.device),
        scaling=float(scaling), admm_it=0, total_newton=0, total_lin_iters=0,
        solver_iters=[0] * (1 + m), converged=False, failed=False,
        u_diff_norm=math.inf, lam_inc_norm=math.inf, max_grad_norm=0.0,
        stats=torch.zeros((cfg.admm_steps, 6), dtype=torch.float64),
    )


def l2_norm_p1(coords, elems, f):
    """sqrt(int |f|^2) for a P1 field f (C, V), exact via the element mass."""
    from ..ops.geometry import elem_geometry

    d = coords.shape[1]
    nl = d + 1
    _, _, _, vol = elem_geometry(coords, elems)
    fe = f[:, elems.T]  # (C, nl, E)
    mfac = torch.as_tensor((np.ones((nl, nl)) + np.eye(nl)) / ((d + 1) * (d + 2)), dtype=f.dtype, device=f.device)
    val = torch.einsum("e,ij,cie,cje->", vol, mfac, fe, fe)
    return torch.sqrt(torch.clamp_min(val, 0.0))


def l2_norm_pc(coords, elems, T):
    """sqrt(int |T|^2) for a piecewise-constant tensor field (d, d, E)."""
    from ..ops.geometry import elem_geometry

    _, _, _, vol = elem_geometry(coords, elems)
    return torch.sqrt(torch.clamp_min(torch.einsum("e,cde,cde->", vol, T, T), 0.0))


def _norm(v) -> float:
    return host_read(torch.sqrt(torch.dot(v, v)), float)


class NewtonResult(NamedTuple):
    u: torch.Tensor
    Lambda: torch.Tensor
    iters: int
    lin_iters: int
    lin_each: list  # (1+m,) per-solve-slot Krylov iteration sums
    failed: bool
    sols: torch.Tensor  # (1+m, ...) st / t_i of the last applied iteration
    # per applied iteration [norm_sum (0.0), |du|, |DLambda|, |Lu|,
    # rhs_iters, constraint_iters...] (reference 2d:1111-1120)
    hist: list
    debug: tuple  # (Lu, rhs_large, du) of the last applied iteration
    batch_iters: int  # per Krylov solve the most iterations of a lane, summed


def _hess_apply(ops_, u, Lambda, ref_volume, ref_barycenter, extra_hvp):
    """x -> (A + Lambda^T g'' + J'') x with the J'' term extra_hvp(x*free)
    * free, for one field or lane by lane for (1+m, ...) (extra_hvp takes
    one field, as the JAX package's jax.vmap hands it one lane)."""
    hvp = ops_.hvp_fn(u, Lambda, ref_volume, ref_barycenter)
    free = ops_.free

    def one(x):
        return ops_.A(x) + hvp(x) + extra_hvp(x * free) * free

    def apply(x):
        return one(x) if x.dim() == free.dim() else torch.stack([one(xi) for xi in x])

    return apply


def _solve_lanes(cfg: ADMMConfig, solver, hess, rhs, x0, ops_) -> krylov.SolveResult:
    """H x = b for the 1+m lanes of rhs, warm-started from x0: one
    lane-batched solve, or with cfg.xsolve_sequential one solve per lane,
    stacked (the JAX package's lax.map)."""
    kw = dict(M=ops_.M, max_iters=cfg.lin_max_iters, abs_tol=cfg.lin_abs_tol, rel_tol=cfg.lin_rel_tol,
              dot=ops_.dot)
    if not cfg.xsolve_sequential:
        return solver(hess, rhs, x0=x0, **kw)
    each = [solver(hess, b, x0=x, **kw) for b, x in zip(rhs, x0)]
    return krylov.SolveResult(*(torch.stack(v) for v in zip(*each)))


def newton_xupdate_ops(
    cfg: ADMMConfig, ops_, Jp_base, scaling, lam, q_proj, ref_volume, ref_barycenter,
    u0, Lambda0, sols0=None, extra_hvp=None,
) -> NewtonResult:
    """Constrained Newton (KKT via the dense m x m Schur complement) on a
    representation adapter (optim.spaces.GlobalOps / PatchOps).  sols0: optional
    (1+m, ...) warm start of the st / t_i solves.  extra_hvp(x) -> J'' x,
    one field in and out (b2nd_order): it joins the stationarity residual
    L_u and the Krylov matvec, which then is _hess_apply instead of the
    assembled ops_.hess_fn."""
    free = ops_.free
    m = Lambda0.shape[0]
    r_lin = scaling * Jp_base * free + ops_.tensor_rhs(lam - cfg.tau * q_proj)
    solver = krylov.cg if cfg.x_solver == "cg" else krylov.bicgstab
    tiny = torch.finfo(u0.dtype).tiny
    u, Lambda = u0, Lambda0
    sols = torch.zeros((1 + m,) + u0.shape, dtype=u0.dtype, device=u0.device) if sols0 is None else sols0
    it = lin = 0
    lin_each = [0] * (1 + m)
    batch = 0
    done = failed = False
    lu0 = g0 = 0.0
    hist = []
    dbg = (torch.zeros_like(u0),) * 3
    # the constraint values of the current iterate: one pass per iterate,
    # read by the Schur update and by the convergence test
    g = ops_.constraints(u, ref_volume, ref_barycenter)
    while not done and not failed and it < cfg.ns_max_its:
        with span("admm.cgrads") as rec:
            B = ops_.constraint_grads(u, ref_volume, ref_barycenter)
            if rec is not None:  # recording: which form computed B
                rec["attrs"]["path"] = ops_.cgrads_path(u)
        Lu = (ops_.A(u) + r_lin + torch.tensordot(Lambda, B, dims=1)) * free
        if extra_hvp is not None:
            # the J'' term is part of the x-update operator (2d:389), so the
            # defect carries it too, or Newton converges to the first-order point
            Lu = Lu + extra_hvp(u * free) * free
        rhs = torch.cat([Lu[None], B])  # (1+m, ...)
        # H x = b for the 1+m lanes at once, warm-started from the previous
        # Newton iteration's solutions; the constraint Hessian is assembled
        # into the stencil once per iterate
        with span("admm.hess") as rec:
            if extra_hvp is None:
                hess = ops_.hess_fn(u, Lambda, ref_volume, ref_barycenter)
            else:
                hess = _hess_apply(ops_, u, Lambda, ref_volume, ref_barycenter, extra_hvp)
            if rec is not None:  # recording: which form assembled the Hessian
                rec["attrs"]["path"] = getattr(hess, "path", "plain")
        with span("admm.lanes"):
            res = _solve_lanes(cfg, solver, hess, rhs, sols, ops_)
        ok_each = res.converged
        if cfg.lin_accept_rel > 0.0:
            ok_each = ok_each | (res.res_norm <= cfg.lin_accept_rel * torch.sqrt(ops_.dot(rhs, rhs)))
        its_each = host_read(res.iters, torch.Tensor.tolist)
        ok = host_read(ok_each.all(), bool)
        it += 1
        lin += sum(its_each)
        lin_each = [a + b for a, b in zip(lin_each, its_each)]
        batch += max(its_each)
        if not ok:
            # a failed Krylov solve must NOT contaminate the iterate: the
            # reference breaks out before applying the update (2d:960/988/1054)
            failed = True
            break
        with span("admm.schur"):
            # Schur assembly in one Gram pass: col 0 = B.st, cols 1: = S
            G = ops_.dot_batch(B, res.x)
            dLambda = torch.linalg.solve(G[:, 1:], g - G[:, 0])
            du = -res.x[0] - torch.tensordot(dLambda, res.x[1:], dims=1)
            u = (u + du) * free
            Lambda = Lambda + dLambda
        sols = res.x
        # -bDebugOutput fields: the pre-update defect Lu, the eliminated
        # large problem's RHS, and the increment
        dbg = (Lu, -(Lu + torch.tensordot(dLambda, B, dims=1)) * free, du)
        # convergence (reference 2d:1163-1169): |Lu| is the PRE-update
        # defect, the constraint norm that of the UPDATED iterate; the
        # relative tests are against the first iteration's norms
        dlam_norm = _norm(dLambda)
        lu_norm = host_read(ops_.norm_p1(Lu), float)
        g = ops_.constraints(u, ref_volume, ref_barycenter)
        g_norm = _norm(g)
        if it == 1:
            lu0, g0 = lu_norm, g_norm
        rel_ok = (lu_norm / max(lu0, tiny) < cfg.ns_rel_tol) and (
            g_norm / max(g0, tiny) < cfg.ns_rel_llambda_tol
        )
        done = (
            dlam_norm <= cfg.ns_tol
            or (lu_norm < cfg.ns_abs_tol and g_norm < cfg.ns_abs_llambda_tol)
            or rel_ok
        )
        hist.append([0.0, host_read(ops_.norm_p1(du * free), float), dlam_norm, lu_norm]
                    + [float(i) for i in its_each])
    # not converging within ns_max_its counts as failure (reference 2d:1084-1090)
    return NewtonResult(u, Lambda, it, lin, lin_each, failed or not done, sols, hist, dbg, batch)


def admm_iteration(cfg: ADMMConfig, ops_, Jp_base, sigma: float, ref_volume, ref_barycenter,
                   st: ADMMState, xsols=None, extra_hvp=None):
    """One ADMM iteration from st: z-update + projection, the Newton
    x-update warm-started from xsols (the previous iteration's st / t_i
    solutions; None = zeros) with extra_hvp (newton_xupdate_ops), dual
    ascent and the convergence logic (2d:1226-1250).  Returns (new state,
    new xsols, NewtonResult, stats row)."""
    with span("admm.z_prox") as rec:
        q_proj = ops_.z_update(st.u, st.lam, cfg.tau, sigma, cfg.norm_name)
        if rec is not None:
            # traced only, and not a host.sync span: the read exists for the
            # trace's sake.  The cells (this rank's) whose tensor the prox moved
            moved = (q_proj != ops_.grad_tensor(st.u) + st.lam / cfg.tau).flatten(0, 1).any(dim=0)
            rec["attrs"]["projected"] = int(moved.sum())
    if cfg.relax_alpha != 1.0:
        # over-relaxation: q_hat enters the x-update and dual ascent
        al = cfg.relax_alpha
        q_hat = al * q_proj + (1.0 - al) * ops_.grad_tensor(st.u)
    else:
        q_hat = q_proj
    max_norm = host_read(ops_.max_grad_norm(st.u_old, cfg.norm_name), float)
    # multipliers carry across ADMM iterations as in the reference
    # (2d:1068-1142); they are zeroed only by a fresh admm_inner call
    with span("admm.newton"):
        nr = newton_xupdate_ops(
            cfg, ops_, Jp_base, st.scaling, st.lam, q_hat, ref_volume, ref_barycenter,
            st.u, st.Lambda, sols0=xsols, extra_hvp=extra_hvp,
        )
    with span("admm.dual"):
        lam, lam_inc = ops_.dual_update(nr.u, st.lam, q_hat, cfg.tau)
    u_diff = host_read(ops_.norm_p1(nr.u - st.u_old), float)
    lam_inc_n = host_read(ops_.norm_pc(lam_inc), float)
    base_conv = (
        lam_inc_n < cfg.admm_tolerance
        and u_diff < cfg.admm_tolerance
        and sigma - max_norm > -cfg.admm_gradient_tolerance * sigma
    )
    fake = base_conv and sigma - max_norm > cfg.admm_gradient_tolerance * sigma
    converged = base_conv and not fake
    row = [st.scaling, sigma, u_diff, lam_inc_n, max_norm, sigma - max_norm]
    stats = st.stats.clone()
    stats[min(st.admm_it, cfg.admm_steps - 1)] = torch.tensor(row, dtype=stats.dtype)
    # fake convergence: double the J' scaling and restart the ADMM counter,
    # keeping u / lambda (reference 2d:1230-1243)
    admm_it = 0 if fake else st.admm_it + 1
    new = ADMMState(
        u=nr.u, u_old=nr.u, lam=lam, q_proj=q_proj, Lambda=nr.Lambda,
        scaling=st.scaling * 2.0 if fake else st.scaling,
        admm_it=admm_it,
        total_newton=st.total_newton + nr.iters,
        total_lin_iters=st.total_lin_iters + nr.lin_iters,
        solver_iters=[a + b for a, b in zip(st.solver_iters, nr.lin_each)],
        converged=converged,
        # convergence is checked BEFORE the max-step failure (2d:1226 precedes 2d:1245)
        failed=nr.failed or (admm_it >= cfg.admm_steps and not converged),
        u_diff_norm=u_diff, lam_inc_norm=lam_inc_n, max_grad_norm=max_norm,
        stats=stats,
        newton_failed=nr.failed,
        batch_iters=st.batch_iters + nr.batch_iters,
    )
    return new, nr.sols, nr, row


def admm_inner(
    cfg: ADMMConfig,
    ops_,
    Jp_base,
    sigma_threshold: float,
    scaling0: float,
    ref_volume,
    ref_barycenter,
    iter_cb=None,
    newton_hist_out: list | None = None,
    full_stats_out: list | None = None,
    debug_out: dict | None = None,
    extra_hvp=None,
) -> ADMMState:
    """The ADMM loop of one optimization step; returns the final state.

    extra_hvp(x) -> J'' x (b2nd_order): newton_xupdate_ops's hook, one
    field (C, V) in and out.

    iter_cb(k, u, Lambda): called after every ADMM iteration with the
    running iteration count k (monotone across fake-convergence restarts),
    the iterate u (-bOutputIntermediateUp, reference 2d:84) and the
    geometric multipliers Lambda the x-update ended with.
    newton_hist_out: filled with the LAST ADMM iteration's per-Newton rows
    (NewtonResult.hist; the reference writes them once per step, 2d:1256-1259).
    full_stats_out: filled with EVERY ADMM stats row, across restarts.
    debug_out: filled with the last Newton iteration's fields under
    "Lu" / "rhs_large" / "du" (-bDebugOutput, 2d:962-1076)."""
    with span("admm.inner"):
        sigma = float(sigma_threshold)
        st = initial_state(cfg, ops_, scaling0, Jp_base.dtype)
        xsols = None
        rows, nr = [], None
        while not st.converged and not st.failed and st.admm_it < cfg.admm_steps:
            with span("admm.iter"):
                st, xsols, nr, row = admm_iteration(
                    cfg, ops_, Jp_base, sigma, ref_volume, ref_barycenter, st, xsols, extra_hvp
                )
            if iter_cb is not None:
                iter_cb(len(rows), st.u, st.Lambda)
            rows.append(row)
    if nr is not None:
        if newton_hist_out is not None:
            newton_hist_out[:] = nr.hist
        if debug_out is not None:
            debug_out["Lu"], debug_out["rhs_large"], debug_out["du"] = nr.debug
    if full_stats_out is not None:
        full_stats_out[:] = rows
    return st


def admm_inner_global(cfg: ADMMConfig, struct, mgdata, coords, elems, free, Jp_base, sigma_threshold: float,
                      scaling0: float, ref_volume, ref_barycenter, vplan=None, **hooks) -> ADMMState:
    """The ADMM loop on the global representation: admm_inner over
    optim.spaces.GlobalOps(struct, mgdata, coords, elems, free) (the JAX
    package's admm_inner(cfg, struct, mgdata, coords, elems, free, ...)).
    vplan: the fixed-order vertex sum of elems (ops.deformation
    .vertex_plan); hooks: admm_inner's iter_cb, newton_hist_out,
    full_stats_out, debug_out and extra_hvp."""
    from .spaces import GlobalOps

    ops_ = GlobalOps(struct, mgdata, coords, elems, free, vplan)
    return admm_inner(cfg, ops_, Jp_base, sigma_threshold, scaling0, ref_volume, ref_barycenter, **hooks)
