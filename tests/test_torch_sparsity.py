"""The port's block-ELL operators (ops/sparsity.py) against the JAX
package's on the 2D channel refined twice and the 3D channel refined once,
float64, from one numpy seed: the assembly through the fixed-order
SegmentSum, spmv in its layouts (with a lane axis), the diagonal, the
in-pattern transpose, and spmv_flat_pair, whose autograd backward is the
spmv on the transposed values and never an index_add.  Operators to
1e-12."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy, refine as jrefine
from admm_optim_tpu.ops import sparsity as jsp
from admm_optim_tpu.ops.convdiff import convdiff_elem_mats as jcd
from admm_optim_tpu_torch.ops import sparsity as sp
from admm_optim_tpu_torch.ops.convdiff import convdiff_elem_mats

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[(2, 2), (3, 1)], ids=["2d_refs2", "3d_refs1"])
def case(request):
    dim, refs = request.param
    levels = [jgeomgen.channel_2d(diag="alt") if dim == 2 else jgeomgen.channel_3d()]
    for _ in range(refs):
        levels.append(jrefine(levels[-1]))
    lvl = JHierarchy(levels).fine
    rng = np.random.default_rng(3 + dim)
    w = rng.normal(size=(dim, lvl.num_vertices))
    fixed = np.repeat(lvl.vertex_mask(("inlet", "wall"))[None], dim, axis=0)
    pat_j = jsp.build_pattern(lvl.elems, lvl.num_vertices, dim)
    vals_j = jsp.bake_dirichlet(
        pat_j, jsp.assemble_values(pat_j, jcd(jnp.asarray(lvl.coords), jnp.asarray(lvl.elems), jnp.asarray(w), 0.05)),
        jnp.asarray(fixed))
    pat = sp.build_pattern(lvl.elems, lvl.num_vertices, dim)
    em = convdiff_elem_mats(torch.as_tensor(lvl.coords), torch.as_tensor(lvl.elems.astype(np.int64)),
                            torch.as_tensor(w), 0.05)
    vals = sp.bake_dirichlet(pat, sp.assemble_values(pat, em), torch.as_tensor(fixed))
    return dict(dim=dim, lvl=lvl, rng=rng, pat_j=pat_j, vals_j=vals_j, pat=pat, vals=vals)


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= tol * max(np.abs(want).max(), 1.0)


def test_assembly_and_diagonal(case):
    _close(case["vals"].numpy(), case["vals_j"])
    _close(sp.diag_cn(case["pat"], case["vals"]).numpy(), jsp.diag_cn(case["pat_j"], case["vals_j"]))


def test_spmv_layouts_and_lanes(case):
    pat, vals, C = case["pat"], case["vals"], case["dim"]
    N = pat.n_rows
    X = case["rng"].normal(size=(3, C * N))
    want = [np.asarray(jsp.spmv_flat(case["pat_j"], case["vals_j"], jnp.asarray(x))) for x in X]
    got = sp.spmv_flat(pat, vals, torch.as_tensor(X)).numpy()
    for g, w in zip(got, want):
        _close(g, w)
    _close(sp.spmv_cn(pat, vals, torch.as_tensor(X[0].reshape(C, N))).numpy().ravel(), want[0])
    _close(sp.spmv(pat, vals, torch.as_tensor(X[0].reshape(C, N).T)).numpy(),
           jsp.spmv(case["pat_j"], case["vals_j"], jnp.asarray(X[0].reshape(C, N).T)))
    x = torch.as_tensor(X[0])
    assert torch.equal(sp.from_flat(x, N), x.reshape(C, N).T)
    assert torch.equal(sp.to_flat(sp.from_flat(x, N)), x)


def test_transpose_values_and_pair_backward(case):
    pat, vals = case["pat"], case["vals"]
    vals_t = sp.transpose_values(pat, vals)
    _close(vals_t.numpy(), jsp.transpose_values(case["pat_j"], case["vals_j"]))
    A = sp.to_dense(pat, vals).numpy()
    assert np.abs(sp.to_dense(pat, vals_t).numpy() - A.T).max() <= 1e-13 * np.abs(A).max()
    x = torch.tensor(case["rng"].normal(size=pat.n_flat), requires_grad=True)
    ct = torch.as_tensor(case["rng"].normal(size=pat.n_flat))
    y = sp.spmv_flat_pair(pat, vals, vals_t, x)
    assert torch.equal(y.detach(), sp.spmv_flat(pat, vals, x.detach()))
    # the backward is a node of the linear call, not autograd's scatter of the gather
    names = set()
    stack = [y.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None:
            names.add(type(node).__name__)
            stack.extend(f for f, _ in node.next_functions)
    assert not any("Index" in n or "Scatter" in n for n in names), names
    (g,) = torch.autograd.grad(y, x, ct)
    assert torch.equal(g, sp.spmv_flat(pat, vals_t, ct))
    _close(g.numpy(), A.T @ ct.numpy())


@pytest.mark.parametrize("n_out,m", [(7, 40), (50, 1000)])
def test_segment_sum_equals_index_add(n_out, m):
    """The GPU's fixed-order form against index_add_ (the CPU's): rows
    with 0, 1 and many contributions, with lane axes."""
    rng = np.random.default_rng(n_out)
    ids = rng.integers(0, n_out - 2, size=m)
    src = torch.as_tensor(rng.normal(size=(2, 3, m)))
    plan = sp.segment_plan(ids, n_out)
    got = plan.gather_sum(src)
    want = src.new_zeros((2, 3, n_out)).index_add_(2, torch.as_tensor(ids), src)
    assert torch.allclose(got, want, rtol=1e-14, atol=1e-14)
    assert float(got[..., n_out - 2:].abs().max()) == 0.0
    assert torch.equal(plan(src), want)
