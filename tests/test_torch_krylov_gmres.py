"""The port's flexible GMRES and GCRO-DR recycling (solvers/krylov.py)
against the JAX package's on the same small dense systems, float64:
the same iterates, residual estimates, recycle spaces U and images C.
Mirrors tests/test_krylov_chunk.py and tests/test_krylov_recycle.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_optim_tpu.solvers import krylov as jk
from admm_optim_tpu_torch.solvers import krylov as tk

torch.set_num_threads(1)


def _dense_problem(n=120, seed=0):
    """Nonsymmetric, diagonally dominant, with a Jacobi preconditioner."""
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4.0 + rng.normal(size=(n, n)) * 0.35
    return A, rng.normal(size=n), 1.0 / np.diag(A)


def _slow_problem(n=144, seed=0, n_small=6):
    """Nonsymmetric with a cluster of small eigenvalues (the modes restarted
    GMRES keeps rediscovering): tests/test_krylov_recycle.py's system."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    evals = np.concatenate([np.linspace(0.01, 0.06, n_small), np.linspace(1.0, 2.0, n - n_small)])
    A = Q @ np.diag(evals) @ Q.T
    P = rng.standard_normal((n, n)) * 0.02
    return A + P - P.T, rng.standard_normal(n)


def _ops(A, Md=None):
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    tA, jA = (lambda x: At @ x), (lambda x: Aj @ x)
    if Md is None:
        return tA, jA, (lambda r: r), (lambda r: r)
    Mt, Mj = torch.from_numpy(Md), jnp.asarray(Md)
    return tA, jA, (lambda r: Mt * r), (lambda r: Mj * r)


def _close(t, j, tol):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    return np.abs(t - j).max() <= tol * max(np.abs(j).max(), 1e-300)


@pytest.mark.parametrize("m,step,limit", [(24, 7, 24), (40, 10, 30), (24, 24, 24)])
def test_chunked_cycle_matches_jax(m, step, limit):
    """One cycle of restart m run in chunks of `step` up to `limit` columns
    (uneven chunks and an early close included): the same estimate after
    each chunk and the same iterate as the JAX package's chunked cycle,
    and for a full cycle the same as the monolithic gmres."""
    A, b, Md = _dense_problem()
    tA, jA, tM, jM = _ops(A, Md)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    V, Z, H, beta = tk.gmres_chunk_start(tA, bt, torch.zeros_like(bt), m)
    Vj, Zj, Hj, betaj = jk.gmres_chunk_start(jA, bj, jnp.zeros_like(bj), m)
    j = 0
    while j < limit:
        ns = min(step, limit - j)
        V, Z, H, est = tk.gmres_chunk_arnoldi(tA, tM, V, Z, H, beta, j, ns)
        Vj, Zj, Hj, estj = jk.gmres_chunk_arnoldi(jA, jM, Vj, Zj, Hj, betaj, j, ns)
        j += ns
        assert abs(est - float(estj)) <= 1e-10 * float(estj)
    assert _close(H.numpy(), np.asarray(Hj), 1e-12)
    x = tk.gmres_chunk_finish(torch.zeros_like(bt), Z, H, beta, j)
    xj = jk.gmres_chunk_finish(jnp.zeros_like(bj), Zj, Hj, betaj)
    assert _close(x.numpy(), np.asarray(xj), 1e-12)
    # without j the filled columns are found from H (JAX's zero columns)
    assert torch.equal(tk.gmres_chunk_finish(torch.zeros_like(bt), Z, H, beta), x)
    true = float(torch.linalg.vector_norm(bt - tA(x)))
    assert abs(est - true) / true < 1e-6
    if j == m:
        ref = tk.gmres(tA, bt, M=tM, restart=m, max_iters=m, abs_tol=1e-30)
        assert _close(x.numpy(), ref.x.numpy(), 1e-12)


def test_restarted_gmres_matches_jax():
    A, b, Md = _dense_problem(seed=3)
    tA, jA, tM, jM = _ops(A, Md)
    r = tk.gmres(tA, torch.from_numpy(b), M=tM, restart=10, max_iters=60, abs_tol=1e-30, rel_tol=1e-10)
    rj = jk.gmres(jA, jnp.asarray(b), M=jM, restart=10, max_iters=60, abs_tol=1e-30, rel_tol=1e-10)
    assert int(r.iters) == int(rj.iters) and bool(r.converged) == bool(rj.converged)
    assert _close(r.x.numpy(), np.asarray(rj.x), 1e-10)
    assert abs(float(r.res_norm) - float(rj.res_norm)) <= 1e-6 * float(rj.res_norm)


def _proj(X):
    """Orthogonal projector onto the row space of X (k, n)."""
    q, _ = np.linalg.qr(np.asarray(X, np.float64).T)
    return q @ q.T


def test_gcro_cycle_and_recycle_space_match_jax():
    """A plain cycle, the recycle space selected from it, a deflated cycle
    and the next refresh, against the JAX package's.  The selected basis of
    U is not a continuous function of the inputs (scipy's eigenvectors
    carry an arbitrary complex phase, and pivoted QR keeps real or
    imaginary parts by it), so the spaces span(U), span(C) are compared;
    the deflated cycle depends on those spaces only and is run on both
    sides from the port's U and C.  The invariants A U^T = C^T, C C^T = I
    and C V^T = 0 hold."""
    A, b = _slow_problem()
    tA, jA, tM, jM = _ops(A)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    m, k = 24, 6
    V, Z, H, beta = tk.gmres_chunk_start(tA, bt, torch.zeros_like(bt), m)
    V, Z, H, _ = tk.gmres_chunk_arnoldi(tA, tM, V, Z, H, beta, 0, m)
    x1 = tk.gmres_chunk_finish(torch.zeros_like(bt), Z, H, beta, m)
    U, C = tk.gcro_update_recycle(None, None, V, Z, H, None, k, m)
    Vj, Zj, Hj, betaj = jk.gmres_chunk_start(jA, bj, jnp.zeros_like(bj), m)
    Vj, Zj, Hj, _ = jk.gmres_chunk_arnoldi(jA, jM, Vj, Zj, Hj, betaj, jnp.asarray(0, jnp.int32), m)
    Uj, Cj = jk.gcro_update_recycle(None, None, Vj, Zj, Hj, None, k, m)
    assert U.shape == (k, b.size)
    assert np.abs(_proj(U) - _proj(Uj)).max() < 1e-10
    assert np.abs(_proj(C) - _proj(Cj)).max() < 1e-10
    assert _close(torch.stack([tA(u) for u in U]).numpy(), C.numpy(), 1e-9)
    assert np.abs(C.numpy() @ C.numpy().T - np.eye(k)).max() < 1e-9

    Uj, Cj = jnp.asarray(U.numpy()), jnp.asarray(C.numpy())
    x_p, V2, Z2, H2, B2, beta2 = tk.gcro_chunk_start(tA, bt, x1, U, C, m)
    jx_p, jV2, jZ2, jH2, jB2, jbeta2 = jk.gcro_chunk_start(jA, bj, jnp.asarray(x1.numpy()), Uj, Cj, m)
    assert float(beta2) <= float(torch.linalg.vector_norm(bt - tA(x1))) + 1e-12
    assert abs(float(beta2) - float(jbeta2)) <= 1e-9 * float(jbeta2)
    for j0 in (0, 12):
        V2, Z2, H2, B2, est = tk.gcro_chunk_arnoldi(tA, tM, C, V2, Z2, H2, B2, beta2, j0, 12)
        jV2, jZ2, jH2, jB2, jest = jk.gcro_chunk_arnoldi(
            jA, jM, Cj, jV2, jZ2, jH2, jB2, jbeta2, jnp.asarray(j0, jnp.int32), 12
        )
        assert abs(est - float(jest)) <= 1e-8 * float(jest)
    assert float(torch.abs(C @ V2[:m].T).max()) < 1e-8
    assert _close(B2.numpy(), np.asarray(jB2), 1e-8) and _close(H2.numpy(), np.asarray(jH2), 1e-8)
    x2 = tk.gcro_chunk_finish(x_p, Z2, H2, B2, beta2, U, m)
    x2j = jk.gcro_chunk_finish(jx_p, jZ2, jH2, jB2, jbeta2, Uj)
    assert _close(x2.numpy(), np.asarray(x2j), 1e-8)
    assert abs(est - float(torch.linalg.vector_norm(bt - tA(x2)))) <= 1e-6 * est + 1e-10
    # the refresh from a deflated cycle: here the selection cuts through
    # complex pairs, so even span(U) moves with the last bits of its
    # inputs; on the same host arrays it is the JAX package's selection,
    # and the invariants hold
    U3, C3 = tk.gcro_update_recycle(U, C, V2, Z2, H2, B2, k, m)
    assert U3.shape == (k, b.size)
    assert _close(torch.stack([tA(u) for u in U3]).numpy(), C3.numpy(), 1e-8)
    assert np.abs(C3.numpy() @ C3.numpy().T - np.eye(k)).max() < 1e-9
    host = [a.numpy() for a in (H2, B2, *tk.gcro_overlaps(U, C, V2, Z2))]
    for a, b_ in zip(tk.gcro_recycle_select(*host, k, m), jk.gcro_recycle_select(*host, k, m)):
        np.testing.assert_array_equal(a, b_)
    # the device assembly from given coefficients is the JAX package's
    rng = np.random.default_rng(4)
    cD, cC = rng.normal(size=(k + m, 3)), rng.normal(size=(k + m + 1, 3))
    Ub, Cb = tk.gcro_recycle_build(U, C, V2, Z2, cD, cC)
    Ubj, Cbj = jk.gcro_recycle_build(Uj, Cj, jnp.asarray(V2.numpy()), jnp.asarray(Z2.numpy()), cD, cC)
    assert _close(Ub.numpy(), np.asarray(Ubj), 1e-13) and _close(Cb.numpy(), np.asarray(Cbj), 1e-13)


def test_gcro_prepare_reimages_exactly():
    """gcro_prepare against the drifted operator: A' U'^T = C'^T with C'
    row-orthonormal, and the JAX package's U', C'."""
    A, _ = _slow_problem(seed=5)
    rng = np.random.default_rng(9)
    U0 = rng.standard_normal((5, A.shape[0]))
    A2 = A + 0.01 * rng.standard_normal(A.shape)
    tA, jA, _, _ = _ops(A2)
    U, C = tk.gcro_prepare(tA, torch.from_numpy(U0))
    Uj, Cj = jk.gcro_prepare(jA, jnp.asarray(U0))
    assert _close(torch.stack([tA(u) for u in U]).numpy(), C.numpy(), 1e-10)
    assert np.abs(C.numpy() @ C.numpy().T - np.eye(5)).max() < 1e-12
    assert _close(U.numpy(), np.asarray(Uj), 1e-10) and _close(C.numpy(), np.asarray(Cj), 1e-10)


def test_recycle_select_degenerate_cases():
    """A one-column cycle keeps the old space; the selection is the JAX
    package's function on the same host arrays."""
    A, b = _slow_problem(seed=2)
    tA, _, tM, _ = _ops(A)
    bt = torch.from_numpy(b)
    V, Z, H, beta = tk.gmres_chunk_start(tA, bt, torch.zeros_like(bt), 8)
    V, Z, H, _ = tk.gmres_chunk_arnoldi(tA, tM, V, Z, H, beta, 0, 1)
    U, C = tk.gcro_update_recycle(None, None, V, Z, H, None, 4, 1)
    assert U.shape == (0, b.size) and C.shape == (0, b.size)
    V, Z, H, _ = tk.gmres_chunk_arnoldi(tA, tM, V, Z, H, beta, 1, 7)
    Bz = np.zeros((0, 8))
    args = (H.numpy(), Bz, np.zeros((0, 0)), np.zeros((0, 8)), np.zeros((9, 0)), (V @ Z.T).numpy(), 4, 8)
    cD, cC = tk.gcro_recycle_select(*args)
    jD, jC = jk.gcro_recycle_select(*args)
    np.testing.assert_array_equal(cD, jD)
    np.testing.assert_array_equal(cC, jC)
