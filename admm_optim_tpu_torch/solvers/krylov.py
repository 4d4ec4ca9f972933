"""Preconditioned conjugate gradients, BiCGStab, flexible GMRES and its
GCRO-DR recycling (port of admm_optim_tpu/solvers/krylov.py).

ConvCheck semantics as in the JAX package: stop when ||r|| <= abs_tol or
||r||/||r0|| <= rel_tol, or after max_iters; return the iterate, the
iteration count, the final residual norm and a convergence flag.  The
``lax.while_loop`` becomes a host loop that reads one flag per iteration,
as eager code must.

CG and BiCGStab take a single right-hand side or a batch of lanes, and a lane
batch reproduces ``jax.vmap`` of the JAX solver: ``dot`` then returns one
value per lane, every scalar of the recurrence is a (B,) tensor, a lane
whose loop condition is false is frozen with ``torch.where``, and the loop
runs until no lane is active.  Budgets (``max_iters``) and tolerances are
per lane.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.profiling import host_read, span


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor  # int64, one per lane (0-d for a single solve)
    res_norm: torch.Tensor
    converged: torch.Tensor  # bool, one per lane


def _vdot(x, y):
    return torch.sum(x * y)


def _lane(s, x):
    """Per-lane scalars s (B,) (or 0-d) broadcast against fields x."""
    return s.reshape(s.shape + (1,) * (x.dim() - s.dim()))


def _freeze(active, n_active, new, old):
    """Keep the new values of active lanes and the old ones elsewhere;
    where every lane is active (always, for a single solve) the new values
    are taken as they are."""
    if n_active == active.numel():
        return new
    return tuple(torch.where(_lane(active, a), a, b) for a, b in zip(new, old))


def cg(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    max_iters: int = 2000,
    abs_tol: float = 1e-12,
    rel_tol: float = 0.0,
    dot: Callable | None = None,
) -> SolveResult:
    """dot: custom inner product (e.g. owner-weighted for duplicated
    brick-patch vectors, solvers.patch_mg); defaults to the plain sum."""
    if dot is None:
        dot = _vdot
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731
    r = b - A(x0)
    z = M(r)
    nrm = torch.sqrt(dot(r, r))
    tol = torch.clamp_min(rel_tol * nrm, abs_tol)
    rz = dot(r, z)
    it = torch.zeros(nrm.shape, dtype=torch.int64, device=nrm.device)
    x, p = x0, z
    while True:
        active = (nrm > tol) & (it < max_iters)
        n_active = host_read(active.sum(), int)
        if n_active == 0:
            break
        with span("cg.iter"):
            Ap = A(p)
            denom = dot(p, Ap)
            alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
            x_n = x + _lane(alpha, p) * p
            r_n = r - _lane(alpha, Ap) * Ap
            z = M(r_n)
            rz_new = dot(r_n, z)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            p_n = z + _lane(beta, p) * p
            x, r, p, rz, nrm = _freeze(
                active, n_active,
                (x_n, r_n, p_n, rz_new, torch.sqrt(dot(r_n, r_n))), (x, r, p, rz, nrm),
            )
            it = it + active
    return SolveResult(x, it, nrm, nrm <= tol)


def bicgstab(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    max_iters: int = 2000,
    abs_tol: float = 1e-12,
    rel_tol: float = 0.0,
    dot: Callable | None = None,
    restarts: int = 2,
    floor: float = 50.0,
) -> SolveResult:
    """Right-preconditioned BiCGStab, mirroring the reference's
    bicgstab+gmg linear solver preset.

    restarts: recurrence rounds within the shared max_iters budget; each
    round after the first restarts from the TRUE residual of the previous
    round's iterate, because the recurred residual drifts from it in f32.
    The convergence flag is taken on a true residual.

    floor: attainable-residual clamp, the target is
    max(abs_tol, rel_tol*|r0|, floor*eps*|b|), fixed by each lane's first
    round; floor=0 disables it."""
    if dot is None:
        dot = _vdot
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731

    def nrm_of(v):
        return torch.sqrt(dot(v, v))

    eps = torch.finfo(b.dtype).eps
    tol = None
    x = x0
    its_total = None
    for _ in range(max(1, restarts)):
        r0 = b - A(x)
        nrm0 = nrm_of(r0)
        if tol is None:  # first round's true residual defines the target
            tol = torch.clamp_min(rel_tol * nrm0, abs_tol)
            tol = torch.maximum(tol, floor * eps * nrm_of(b))
            its_total = torch.zeros(nrm0.shape, dtype=torch.int64, device=nrm0.device)
        x, its = _bicgstab_round(A, b, x, r0, nrm0, M, dot, nrm_of, tol, max_iters - its_total)
        its_total = its_total + its
    nrm_true = nrm_of(b - A(x))
    return SolveResult(x, its_total, nrm_true, nrm_true <= tol)


def _bicgstab_round(A, b, x, r, nrm, M, dot, nrm_of, tol, budget):
    """One BiCGStab recurrence from the given (true) initial residual."""
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones(nrm.shape, dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    it = torch.zeros(nrm.shape, dtype=torch.int64, device=b.device)
    ok = torch.ones(nrm.shape, dtype=torch.bool, device=b.device)
    # dtype-aware breakdown detection (1e-300 would never trigger in f32,
    # where everything below ~1e-38 flushes to zero)
    brk = _breakdown_eps(b.dtype)
    while True:
        active = (nrm > tol) & (it < budget) & ok
        n_active = host_read(active.sum(), int)
        if n_active == 0:
            break
        rho_new = dot(rhat, r)
        beta = (rho_new / _safe(rho)) * (alpha / _safe(omega))
        p_n = r + _lane(beta, r) * (p - _lane(omega, v) * v)
        phat = M(p_n)
        v_n = A(phat)
        denom = dot(rhat, v_n)
        alpha_n = rho_new / _safe(denom)
        s = r - _lane(alpha_n, v_n) * v_n
        shat = M(s)
        t = A(shat)
        omega_n = dot(t, s) / _safe(dot(t, t))
        x_n = x + _lane(alpha_n, phat) * phat + _lane(omega_n, shat) * shat
        r_n = s - _lane(omega_n, t) * t
        bad = (torch.abs(rho_new) < brk) | (torch.abs(denom) < brk)
        x, r, p, v, rho, alpha, omega, nrm, ok = _freeze(
            active, n_active,
            (x_n, r_n, p_n, v_n, rho_new, alpha_n, omega_n, nrm_of(r_n), ~bad),
            (x, r, p, v, rho, alpha, omega, nrm, ok),
        )
        it = it + active
    return x, it


def _breakdown_eps(dtype):
    # well above the flush-to-zero threshold, far below any healthy scalar
    return torch.finfo(dtype).tiny * 1e4


def _safe(x):
    """x with every |x| below the breakdown threshold replaced by the
    threshold, keeping the sign."""
    t = torch.full_like(x, _breakdown_eps(x.dtype))
    return torch.where(torch.abs(x) < t, torch.where(x < 0, -t, t), x)


# ---------------------------------------------------------------------------
# flexible GMRES, one Arnoldi cycle stepped from the host in chunks
# ---------------------------------------------------------------------------
#
# The cycle's bases stay on the device: V (m+1, n) with V[0] = r/|r|, the
# preconditioned directions Z (m, n), the Hessenberg H (m+1, m).  After each
# chunk of Arnoldi steps the host reads the least-squares residual ESTIMATE
# of the filled subspace (the GMRES residual in exact arithmetic) - one
# host sync per chunk, and the JAX package's drivers count iterations in
# the same chunk units.  The least-squares problem over the FILLED block
# H[:j+1, :j] (at most 401 x 400) is solved on the host in float64 with the
# minimum-norm LAPACK driver; the JAX package solves it over the whole H,
# whose unfilled zero columns drop out of its minimum-norm solution.


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


def _to_host(a):
    """A device tensor as a float64 numpy array: a blocking read."""
    return a.detach().to("cpu", torch.float64).numpy()


def _to_device(a, like):
    """A host array as a tensor of like's dtype on like's device: a copy
    from pageable memory, which waits for the device's queue, so a
    host.sync span."""
    with span("host.sync"):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _lstsq(H, beta, j: int):
    """y minimizing |beta e1 - H[:j+1, :j] y| (float64 numpy) and that
    minimum, the residual estimate."""
    with span("host.sync"):  # the copy waits for the device; beta is ready with it
        Hj = _to_host(H[: j + 1, :j])
        e1 = np.zeros(j + 1)
        e1[0] = float(beta)
    y = np.linalg.lstsq(Hj, e1, rcond=None)[0]
    return y, float(np.linalg.norm(Hj @ y - e1))


def _filled(H) -> int:
    """Number of filled Arnoldi columns: the last nonzero column + 1."""
    nz = torch.nonzero(H.abs().sum(0)).flatten()
    return int(nz[-1]) + 1 if nz.numel() else 0


def _arnoldi_steps(A, M, V, Z, H, j0: int, nsteps: int, C=None, B=None):
    """Arnoldi steps j0 .. j0+nsteps-1 in place: MGS plus one
    reorthogonalization pass against the filled V (rows above j are zero
    in the JAX package's full-basis projection and add nothing).  With a
    recycle space C (k, n) the new direction first loses its C-component,
    in both passes, recorded in B[:, j]."""
    for j in range(j0, j0 + nsteps):
        z = M(V[j])
        w = A(z)
        Vj = V[: j + 1]
        if C is not None:
            b1 = C @ w
            w = w - b1 @ C
        h1 = Vj @ w
        w = w - h1 @ Vj
        if C is not None:
            b2 = C @ w
            w = w - b2 @ C
            B[:, j] = b1 + b2
        h2 = Vj @ w
        w = w - h2 @ Vj
        wn = _norm(w)
        V[j + 1] = w / torch.clamp_min(wn, 1e-30)
        H[: j + 1, j] = h1 + h2
        H[j + 1, j] = wn
        Z[j] = z


def _bases(b, m: int):
    n = b.shape[0]
    return b.new_zeros((m + 1, n)), b.new_zeros((m, n)), b.new_zeros((m + 1, m))


def gmres_chunk_start(A, b, x0, m: int):
    """Begin one flexible-GMRES cycle at x0.  Returns (V, Z, H, beta) with
    V[0] = r/|r| and beta = |b - A x0|, the true residual norm at x0."""
    r = b - A(x0)
    beta = _norm(r)
    V, Z, H = _bases(b, m)
    V[0] = r / torch.clamp_min(beta, 1e-30)
    return V, Z, H, beta


def gmres_chunk_arnoldi(A, M, V, Z, H, beta, j0: int, nsteps: int):
    """Run Arnoldi steps j0 .. j0+nsteps-1 of the cycle.  Returns the
    advanced (V, Z, H) and the least-squares residual estimate (float) of
    the filled subspace."""
    _arnoldi_steps(A, M, V, Z, H, int(j0), nsteps)
    return V, Z, H, _lstsq(H, beta, int(j0) + nsteps)[1]


def gmres_chunk_finish(x0, Z, H, beta, j: int | None = None):
    """Close the cycle over its j filled columns (found from H when not
    given): x0 + Z^T y."""
    j = _filled(H) if j is None else j
    y, _ = _lstsq(H, beta, j)
    return x0 + _to_device(y, Z) @ Z[:j]


def gmres(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    restart: int = 40,
    max_iters: int = 400,
    abs_tol: float = 1e-12,
    rel_tol: float = 0.0,
) -> SolveResult:
    """Restarted flexible GMRES (MGS + reorthogonalization) with full
    cycles: each cycle runs its whole restart length, keeps the better of
    the old and new iterate, and ``iters`` counts cycles * restart."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731
    m = restart
    n_cycles = max(1, -(-max_iters // restart))
    nrm = _norm(b - A(x0))
    tol = torch.clamp_min(rel_tol * nrm, abs_tol)
    x, it = x0, 0
    while bool(nrm > tol) and it < n_cycles:
        V, Z, H, beta = gmres_chunk_start(A, b, x, m)
        _arnoldi_steps(A, M, V, Z, H, 0, m)
        x_new = gmres_chunk_finish(x, Z, H, beta, m)
        nrm_new = _norm(b - A(x_new))
        if bool(nrm_new < nrm):
            x, nrm = x_new, nrm_new
        it += 1
    return SolveResult(x, torch.tensor(it * m), nrm, nrm <= tol)


# ---------------------------------------------------------------------------
# recycled deflation (GCRO-DR) over the chunked cycle
# ---------------------------------------------------------------------------
#
# A recycle space U (k, n) of approximate slow eigendirections with its
# exact image C = A U (rows orthonormal, C orthogonal to V); each Arnoldi
# step deflates C out of the new direction; the minimization runs over
# span(U) + span(Z); at cycle end harmonic Ritz vectors of A over
# span([U, Z]) (a small generalized pencil solved on the host) select the k
# directions carried into the next cycle and the next solve [Parks, de
# Sturler, Mackey, Johnson, Maiti, SIAM J. Sci. Comput. 28 (2006)].


def gcro_prepare(A, U):
    """Re-image a recycle space against the current operator: C_raw = A U,
    thin QR C_raw^T = Q R, so A (U^T R^-1) = Q.  Returns (U', C') with C'
    row-orthonormal (k applies of A, no preconditioner)."""
    C = torch.stack([A(u) for u in U])
    Q, R = torch.linalg.qr(C.T)
    Un = torch.linalg.solve_triangular(R.T, U, upper=False)
    return Un, Q.T


def gcro_chunk_start(A, b, x0, U, C, m: int):
    """Begin one deflated cycle: move the C-component of the residual into
    the iterate (x += U^T C r; r -= C^T C r) and set up the bases.  Returns
    (x, V, Z, H, B, beta), beta the true residual norm at x."""
    r = b - A(x0)
    al = C @ r
    x = x0 + al @ U
    r = r - al @ C
    beta = _norm(r)
    V, Z, H = _bases(b, m)
    V[0] = r / torch.clamp_min(beta, 1e-30)
    return x, V, Z, H, b.new_zeros((U.shape[0], m)), beta


def gcro_chunk_arnoldi(A, M, C, V, Z, H, B, beta, j0: int, nsteps: int):
    """Arnoldi steps j0 .. j0+nsteps-1 of the deflated cycle; the estimate
    is the exact GMRES residual of the deflated system."""
    _arnoldi_steps(A, M, V, Z, H, int(j0), nsteps, C=C, B=B)
    return V, Z, H, B, _lstsq(H, beta, int(j0) + nsteps)[1]


def gcro_chunk_finish(x0, Z, H, B, beta, U, j: int | None = None):
    """Close the deflated cycle: x0 + Z^T y - U^T (B y); the U-correction
    cancels the C-components that A Z^T reintroduces."""
    j = _filled(H) if j is None else j
    y, _ = _lstsq(H, beta, j)
    yt = _to_device(y, Z)
    return x0 + yt @ Z[:j] - (B[:, :j] @ yt) @ U


def gcro_recycle_select(H, B, CU, CZ, VU, VZ, k_new: int, j: int):
    """Host harmonic Ritz selection over span([U, Z[:j]]) (numpy in,
    numpy out; the pencil is (k+j)-dimensional).

    With D = [U^T, Z^T] and A D = [C^T, V^T] G, G = [[I_k, B], [0, H]], the
    harmonic Ritz condition is the pencil (G^T G) g = theta (G^T W) g with
    W = [[C U^T, C Z^T], [V U^T, V Z^T]]; the smallest |theta| are the
    slowest modes.  Complex pairs give their real and imaginary parts; rank
    reduction by pivoted QR.  Returns (coef_D, coef_C) such that
        U' = coef_D[:k]^T U + coef_D[k:]^T Z,  C' = coef_C[:k]^T C + coef_C[k:]^T V
    with A U'^T = C'^T and C' row-orthonormal, or None."""
    import scipy.linalg as sla

    k = B.shape[0]
    Hj = np.asarray(H, np.float64)[: j + 1, :j]
    Bj = np.asarray(B, np.float64)[:, :j]
    G = np.zeros((k + j + 1, k + j))
    G[:k, :k] = np.eye(k)
    G[:k, k:] = Bj
    G[k:, k:] = Hj
    W = np.zeros((k + j + 1, k + j))
    W[:k, :k] = np.asarray(CU, np.float64)
    W[:k, k:] = np.asarray(CZ, np.float64)[:, :j]
    W[k:, :k] = np.asarray(VU, np.float64)[: j + 1]
    W[k:, k:] = np.asarray(VZ, np.float64)[: j + 1, :j]
    theta, g = sla.eig(G.T @ G, G.T @ W)
    theta = np.where(np.isfinite(theta), theta, np.inf)
    order = np.argsort(np.abs(theta))
    cols = []
    for i in order[: 2 * k_new]:
        if not np.isfinite(theta[i]):
            break
        v = g[:, i]
        cols.append(v.real)
        if np.abs(v.imag).max() > 0:
            cols.append(v.imag)
    if not cols:
        return None
    q, r, _ = sla.qr(np.stack(cols, axis=1), pivoting=True, mode="economic")
    rd = np.abs(np.diag(r))
    kk = min(k_new, int((rd > max(rd[0], 1e-300) * 1e-10).sum()))
    if kk == 0:
        return None
    Gsel = q[:, :kk]
    # exact images in the [C; V] frame, orthonormalized through the small
    # factor S = Qs Rs
    Qs, Rs = np.linalg.qr(G @ Gsel)
    coef_D = sla.solve_triangular(Rs.T, Gsel.T, lower=True).T
    m = H.shape[1]
    cD = np.zeros((k + m, kk))
    cD[: k + j] = coef_D
    cC = np.zeros((k + m + 1, kk))
    cC[:k] = Qs[:k]
    cC[k : k + j + 1] = Qs[k:]
    return cD, cC


def gcro_recycle_build(U, C, V, Z, coef_D, coef_C):
    """The new recycle space from host-selected coefficients (device
    GEMMs)."""
    k = U.shape[0]
    cD = _to_device(coef_D, U)
    cC = _to_device(coef_C, U)
    return cD[:k].T @ U + cD[k:].T @ Z, cC[:k].T @ C + cC[k:].T @ V


def gcro_overlaps(U, C, V, Z):
    """The four cross-Gram blocks of the harmonic Ritz pencil (device)."""
    return C @ U.T, C @ Z.T, V @ U.T, V @ Z.T


def gcro_update_recycle(U, C, V, Z, H, B, k: int, j: int):
    """One recycle-space refresh from a finished (possibly partial) cycle
    of j filled columns: selection on the host, assembly on the device.  U
    may be None (first cycle: candidates from span(Z) alone).  Returns
    (U', C'), or (U, C) unchanged if the selection degenerates."""
    m, n = H.shape[1], Z.shape[1]
    if U is None or U.shape[0] == 0:
        U = Z.new_zeros((0, n))
        C = Z.new_zeros((0, n))
    if B is None:
        B = Z.new_zeros((0, m))
    if j <= 1:
        return U, C

    blocks = (H, B, *gcro_overlaps(U, C, V, Z))
    with span("host.sync"):  # the first copy waits for the device, the rest for their own
        host = [_to_host(a) for a in blocks]
    sel = gcro_recycle_select(*host, k, j)
    if sel is None:
        return U, C
    return gcro_recycle_build(U, C, V, Z, *sel)
