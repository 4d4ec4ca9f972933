"""The port's geometric multigrid with block-ELL levels (solvers/mg.py,
ops/p1space.py) against the JAX package's, float64, mirroring
tests/test_mg.py at 2D refs=2 (the channel's default diagonals) and on
the 3D channel refined once: the assembled levels, one V-cycle (Chebyshev
on the deformation operator; Jacobi on a conv-diff operator with its
transposed values, with lanes), V-cycle-preconditioned CG with the JAX
package's iteration counts, and the autograd transpose of the Jacobi cycle
equal to the JAX package's jax.vjp.  Operators to 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy, refine as jrefine
from admm_optim_tpu.ops.p1space import P1VectorSpace as JSpace
from admm_optim_tpu.solvers import krylov as jkrylov
from admm_optim_tpu.solvers import mg as jmg
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.ops import sparsity
from admm_optim_tpu_torch.ops.p1space import P1VectorSpace
from admm_optim_tpu_torch.solvers import krylov, mg

torch.set_num_threads(1)


def _hiers(dim, refs):
    out = []
    for gm, rf, H in ((jgeomgen, jrefine, JHierarchy), (geomgen, refine, Hierarchy)):
        levels = [gm.channel_2d() if dim == 2 else gm.channel_3d()]
        for _ in range(refs):
            levels.append(rf(levels[-1]))
        out.append(H(levels))
    return out


@pytest.fixture(scope="module", params=[(2, 2), (3, 1)], ids=["2d_refs2", "3d_refs1"])
def case(request):
    dim, refs = request.param
    jh, th = _hiers(dim, refs)
    jsp_, tsp = JSpace.build(jh), P1VectorSpace.build(th)
    jst, tst = jsp_.mg_structure(), tsp.mg_structure()
    X = th.fine.coords
    jdata = jsp_.assemble_mg(jst, jnp.asarray(X), 1.0, 1.0, 1.0)
    tdata = tsp.assemble_mg(tst, torch.as_tensor(X), 1.0, 1.0, 1.0)
    rng = np.random.default_rng(dim)
    free = (~tsp.fixed[-1]).astype(float).reshape(-1)
    return dict(dim=dim, jh=jh, th=th, jsp=jsp_, tsp=tsp, jst=jst, tst=tst, jdata=jdata, tdata=tdata, rng=rng,
                free=free)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-300)


def test_levels_equal(case):
    j, t = case["jdata"], case["tdata"]
    for l in range(len(t.vals)):
        assert _rel(t.vals[l].numpy(), j.vals[l]) <= 1e-12
        assert _rel(t.diag[l].numpy(), j.diag[l]) <= 1e-12
        assert _rel(t.free[l].numpy(), j.free[l]) == 0.0
        assert abs(float(t.lmax[l]) - float(j.lmax[l])) <= 1e-12 * float(j.lmax[l])
    assert _rel(t.base_inv.numpy(), j.base_inv) <= 1e-10


def test_build_mg_data_equals_assemble_mg(case):
    """build_mg_data from per-level element matrices, masks and transfers
    gives the space's assembled levels."""
    from admm_optim_tpu_torch.ops.deformation import deformation_elem_mats

    tsp, t = case["tsp"], case["tdata"]
    X = torch.as_tensor(case["th"].fine.coords)

    def em(l):
        elems, _ = tsp.level_tensors(l, "cpu")
        return deformation_elem_mats(X[: tsp.nv[l]], elems, 1.0, 1.0, 1.0)

    d = mg.build_mg_data(case["tst"], em, [tsp.level_tensors(l, "cpu")[1] for l in range(len(tsp.patterns))],
                         tsp.parents)
    for l in range(len(d.vals)):
        assert torch.equal(d.vals[l], t.vals[l]) and torch.equal(d.lmax[l], t.lmax[l])
        assert torch.equal(d.free[l], t.free[l])
    assert torch.equal(d.base_inv, t.base_inv)


def test_vcycle_and_lanes(case):
    b = case["rng"].normal(size=(2, case["free"].size)) * case["free"]
    got = mg.vcycle(case["tst"], case["tdata"], torch.as_tensor(b)).numpy()
    for g, bb in zip(got, b):
        want = jmg.vcycle(case["jst"], case["jdata"], jnp.asarray(bb))
        assert _rel(g, want) <= 1e-12
    pat = case["tsp"].fine_pattern
    r = bb - sparsity.spmv_flat(pat, case["tdata"].vals[-1], torch.as_tensor(got[-1])).numpy()
    assert np.linalg.norm(r) / np.linalg.norm(bb) < 0.2  # tests/test_mg.py's contraction


def test_mg_cg_counts(case):
    b = case["rng"].normal(size=case["free"].size) * case["free"]
    jpat, tpat = case["jsp"].fine_pattern, case["tsp"].fine_pattern
    jres = jkrylov.cg(lambda x: jmg.sparsity.spmv_flat(jpat, case["jdata"].vals[-1], x), jnp.asarray(b),
                      M=jmg.make_preconditioner(case["jst"], case["jdata"]), max_iters=60, abs_tol=1e-11)
    tres = krylov.cg(lambda x: sparsity.spmv_flat(tpat, case["tdata"].vals[-1], x), torch.as_tensor(b),
                     M=mg.make_preconditioner(case["tst"], case["tdata"]), max_iters=60, abs_tol=1e-11)
    assert bool(tres.converged) and bool(jres.converged)
    assert int(tres.iters) == int(jres.iters) < 25
    assert _rel(tres.x.numpy(), jres.x) <= 1e-9


def test_jacobi_convdiff_cycle_and_its_transpose(case):
    """The NS velocity block's cycle: Jacobi V(2,2) on conv-diff levels with
    their transposed values; autograd of the port's cycle is the JAX
    package's jax.vjp, and it records no index_add."""
    import dataclasses

    dim = case["dim"]
    w = case["rng"].normal(size=(dim, case["th"].fine.num_vertices))
    X = case["th"].fine.coords
    jst = dataclasses.replace(case["jst"], pre_smooth=2, post_smooth=2, smoother="jacobi")
    tst = dataclasses.replace(case["tst"], pre_smooth=2, post_smooth=2, smoother="jacobi")
    jd = case["jsp"].assemble_mg_convdiff(jst, jnp.asarray(X), jnp.asarray(w), 0.05, with_transpose=True)
    td = case["tsp"].assemble_mg_convdiff(tst, torch.as_tensor(X), torch.as_tensor(w), 0.05, with_transpose=True)
    for l in range(len(td.vals)):
        assert _rel(td.vals_t[l].numpy(), jd.vals_t[l]) <= 1e-12
    b = case["rng"].normal(size=case["free"].size)
    assert _rel(mg.vcycle(tst, td, torch.as_tensor(b)).numpy(), jmg.vcycle(jst, jd, jnp.asarray(b))) <= 1e-12
    x0 = torch.zeros(b.size, dtype=torch.float64, requires_grad=True)
    with torch.enable_grad():
        y = mg.vcycle(tst, td, x0)
    names, stack = set(), [y.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and type(node).__name__ not in names:
            names.add(type(node).__name__)
            stack.extend(f for f, _ in node.next_functions)
    assert not any("Index" in n or "Scatter" in n for n in names), names
    (g,) = torch.autograd.grad(y, x0, torch.as_tensor(b))
    _, vjp = jax.vjp(lambda r: jmg.vcycle(jst, jd, r), jnp.zeros(b.size))
    assert _rel(g.numpy(), vjp(jnp.asarray(b))[0]) <= 1e-12
