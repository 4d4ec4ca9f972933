"""The port's lane-batched Krylov solvers (solvers/krylov.py) against
jax.vmap of the JAX package's cg and bicgstab: the ADMM x-update's 1+m = 5
simultaneous solves, on the 3D refs=1 fixture's patch operator with the
V-cycle as preconditioner, float64.  One lane converges early, one
right-hand side is zero, one lane starts warm; the iteration cap leaves
some lanes unconverged.  Per-lane iteration counts and flags must be
equal, the iterates agree to 1e-10.  The port runs on the JAX-assembled
operator (convert.py), so both sides apply the same stencils."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from admm_optim_tpu.solvers import krylov as jkrylov
from admm_optim_tpu_torch import convert
from admm_optim_tpu_torch.optim.spaces import PatchOps
from admm_optim_tpu_torch.solvers import krylov, patch_mg
from torch_admm_problems import jax_problem, port_problem

torch.set_num_threads(1)

B = 5
SETTINGS = dict(abs_tol=1e-10, rel_tol=0.0)
MAX_ITERS = {"cg": 12, "bicgstab": 6}


@pytest.fixture(scope="module")
def problem():
    jp = jax_problem(3, 1)
    pp = port_problem(3, 1)
    data = convert.patch_mg_data(jax.tree_util.tree_map(np.asarray, jp.data), pp.ps, "cpu")
    ops = PatchOps(patch_mg.PatchMGStructure(pp.ps), data, pp.ops.coords_p)
    # consistent fields: global vectors read into patch layout
    gid = np.moveaxis(pp.ps.fine.gid, 0, -1)
    free = ops.free.numpy()
    rng = np.random.default_rng(11)
    V = pp.hier.fine.num_vertices
    b = rng.normal(size=(B, 3, V))[..., gid] * free
    b[1] *= 1e-4  # reaches the absolute tolerance early
    b[3] = 0.0  # converged before the first iteration
    x0 = np.zeros_like(b)
    x0[4] = rng.normal(size=(3, V))[..., gid] * free * 0.1  # warm start
    return jp, ops, b, x0


@pytest.mark.parametrize("name", ["cg", "bicgstab"])
def test_batched_solver_matches_jax_vmap(problem, name):
    jp, ops, b, x0 = problem
    jsolve = getattr(jkrylov, name)
    jres = jax.vmap(
        lambda bb, xx: jsolve(
            jp.ops.A, bb, x0=xx, M=jp.ops.M, max_iters=MAX_ITERS[name], dot=jp.ops.dot, **SETTINGS,
        )
    )(jnp.asarray(b), jnp.asarray(x0))
    res = getattr(krylov, name)(
        ops.A, torch.from_numpy(b), x0=torch.from_numpy(x0), M=ops.M,
        max_iters=MAX_ITERS[name], dot=ops.dot, **SETTINGS,
    )
    its = res.iters.tolist()
    assert its == np.asarray(jres.iters).tolist()
    assert res.converged.tolist() == np.asarray(jres.converged).tolist()
    # the designed lane mix: zero RHS at 0 iterations, an early lane, a cap
    assert its[3] == 0 and res.converged[3] and its[1] < max(its)
    assert not bool(res.converged.all())
    x, jx = res.x.numpy(), np.asarray(jres.x)
    assert np.abs(x - jx).max() <= 1e-10 * np.abs(jx).max()
    # a residual norm is a difference of near-equal terms: hold it to the
    # scale of the right-hand sides
    bn = torch.sqrt(ops.dot(torch.from_numpy(b), torch.from_numpy(b))).numpy()
    assert np.abs(res.res_norm.numpy() - np.asarray(jres.res_norm)).max() <= 1e-10 * bn.max()


@pytest.mark.parametrize("name", ["cg", "bicgstab"])
def test_single_solve_equals_its_lane(problem, name):
    """A single right-hand side runs the same recurrence as its lane in a
    batch (no freezing needed while every lane is active)."""
    _, ops, b, x0 = problem
    solve = getattr(krylov, name)
    kw = dict(M=ops.M, max_iters=MAX_ITERS[name], dot=ops.dot, **SETTINGS)
    batch = solve(ops.A, torch.from_numpy(b), x0=torch.from_numpy(x0), **kw)
    one = solve(ops.A, torch.from_numpy(b[0]), x0=torch.from_numpy(x0[0]), **kw)
    assert one.iters.dim() == 0 and int(one.iters) == int(batch.iters[0])
    assert bool(one.converged) == bool(batch.converged[0])
    assert float((one.x - batch.x[0]).abs().max()) <= 1e-12 * float(one.x.abs().max())


def test_safe_keeps_sign_and_breakdown_eps_is_dtype_aware():
    for dt in (torch.float32, torch.float64):
        eps = krylov._breakdown_eps(dt)
        assert eps == torch.finfo(dt).tiny * 1e4 and eps > 0
        x = torch.tensor([0.0, -0.0, eps / 10, -eps / 10, -3.0, 2.0], dtype=dt)
        y = krylov._safe(x)
        assert torch.equal(y, torch.tensor([eps, eps, eps, -eps, -3.0, 2.0], dtype=dt))
