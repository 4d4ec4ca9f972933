"""Double-float arithmetic of the port: the error-free transformations stay
exact in eager PyTorch (no fusion, no contraction), and the DF residual
pieces (stencil apply + exchange) match the JAX package and float64."""
import numpy as np
import torch

import jax.numpy as jnp

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy
from admm_optim_tpu.core.mesh import refine as jrefine
from admm_optim_tpu.core.patches import build_patchset as jbuild_patchset
from admm_optim_tpu.ops import df as jdf
from admm_optim_tpu.ops import patchstencil as jst
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset
from admm_optim_tpu_torch.ops import df
from admm_optim_tpu_torch.ops.deformation import deformation_corner_block_fn
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import stencil_kernels as sk

torch.set_num_threads(1)


def test_two_sum_two_prod_exact():
    """Mirror of tests/test_df.py::test_two_sum_two_prod_exact."""
    rng = np.random.default_rng(0)
    a_np = (rng.normal(size=1000) * 10.0 ** rng.integers(-3, 3, size=1000)).astype(np.float32)
    b_np = rng.normal(size=1000).astype(np.float32)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    s, e = df.two_sum(a, b)
    assert s.dtype == torch.float32
    np.testing.assert_array_equal(
        s.double().numpy() + e.double().numpy(), a_np.astype(np.float64) + b_np
    )
    p, e = df.two_prod(a, b)
    np.testing.assert_array_equal(
        p.double().numpy() + e.double().numpy(), a_np.astype(np.float64) * b_np
    )
    # the same pairs as the JAX package
    js, je = jdf.two_sum(jnp.asarray(a_np), jnp.asarray(b_np))
    np.testing.assert_array_equal(df.two_sum(a, b)[1].numpy(), np.asarray(je))
    jp, je = jdf.two_prod(jnp.asarray(a_np), jnp.asarray(b_np))
    np.testing.assert_array_equal(df.two_prod(a, b)[1].numpy(), np.asarray(je))


def test_df_add_and_renorm_accuracy():
    """Summing 64 floats through DF add stays within 1e-12 of the exact
    sum, and add/renorm give the JAX package's pairs bit for bit."""
    rng = np.random.default_rng(1)
    xs = rng.normal(size=64).astype(np.float32)
    acc = df.from_f(torch.zeros((), dtype=torch.float32))
    jacc = jdf.from_f(jnp.float32(0.0))
    for v in xs:
        acc = df.add(acc, df.from_f(torch.tensor(v)))
        jacc = jdf.add(jacc, jdf.from_f(jnp.float32(v)))
    exact = np.sum(xs.astype(np.float64))
    got = float(acc.hi) + float(acc.lo)
    assert abs(got - exact) <= 1e-12 * max(1.0, abs(exact))
    assert (float(acc.hi), float(acc.lo)) == (float(jacc.hi), float(jacc.lo))
    h, l = df.renorm(torch.tensor(1.0), torch.tensor(1e-9))
    jh, jl = jdf.renorm(jnp.float32(1.0), jnp.float32(1e-9))
    assert (float(h), float(l)) == (float(jh), float(jl))


def test_apply_w_df_and_exchange_accuracy():
    """Mirror of tests/test_df.py::test_apply_w_df_accuracy (3D refs=1):
    the DF apply + error-free exchange in float32 match the float64 stencil
    far beyond the plain float32 path, and match the JAX package's DF
    result."""
    jl = [jgeomgen.channel_3d(n_side=(2, 1, 1))]
    tl = [geomgen.channel_3d(n_side=(2, 1, 1))]
    jl.append(jrefine(jl[0]))
    tl.append(refine(tl[0]))
    jps, tps = jbuild_patchset(JHierarchy(jl)), build_patchset(Hierarchy(tl))
    lvl = tps.fine
    coords_p = st.to_patch(lvl, torch.as_tensor(tl[-1].coords.T, dtype=torch.float32))
    W32 = st.assemble_w(
        tps, tps.k, coords_p, deformation_corner_block_fn(1.0, 1.0, 1.0), sym=True,
        free=torch.as_tensor(lvl.free),
    )
    rng = np.random.default_rng(2)
    x64 = st.to_patch(lvl, torch.as_tensor(rng.normal(size=(3, tl[-1].num_vertices))))
    x32 = x64.float()
    xlo = (x64 - x32.double()).float()
    tab32 = st.make_tables(lvl, torch.float32)
    tab64 = st.make_tables(lvl, torch.float64)
    y64 = st.exchange_sum(None, sk._apply_w_sym(tps, W32.double(), x64), tab64)
    y32 = st.exchange_sum(None, st.apply_w(tps, W32, x32), tab32)
    yh, yl = st.apply_w_df(tps, W32, x32, xlo)
    yh, yl = st.exchange_sum_df(tab32, yh, yl)
    ydf = yh.double() + yl.double()
    scale = float(y64.abs().max())
    err32 = float((y32.double() - y64).abs().max()) / scale
    errdf = float((ydf - y64).abs().max()) / scale
    assert errdf < 1e-12
    assert errdf < err32 / 1e4
    # the JAX package's DF apply + exchange on the same float32 operator
    jW = jnp.asarray(W32.numpy())
    jh, jl_ = jst.apply_w_df(jps, jW, jnp.asarray(x32.numpy()), jnp.asarray(xlo.numpy()))
    jh, jl_ = jst.exchange_sum_df(jst.make_tables(jps.fine, jnp.float32), jh, jl_)
    yj = np.asarray(jh, np.float64) + np.asarray(jl_, np.float64)
    assert np.abs(ydf.numpy() - yj).max() / scale < 1e-13

