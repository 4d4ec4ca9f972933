"""Plain twins of the three ported stencil kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_patches.py runs them, plus the wrappers' dispatch rules.

The CUDA kernels themselves run only on the GPU; chip_smoke.py holds each
of them against these twins there."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core.mesh import Hierarchy as JHierarchy
from admm_optim_tpu.core.mesh import refine as jrefine
from admm_optim_tpu.core.patches import build_patchset as jbuild_patchset
from admm_optim_tpu.ops import pallas_stencil as pst
from admm_optim_tpu.ops import patchstencil as jst
from admm_optim_tpu.ops.deformation import deformation_corner_mats
from admm_optim_tpu_torch import _build
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import stencil_kernels as sk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    """refs=2 channel (lattice 5^3): JAX and port patchsets, and a sym W
    assembled by the JAX package, in float32."""
    jl = [jgeomgen.channel_3d(n_side=(2, 1, 1))]
    tl = [geomgen.channel_3d(n_side=(2, 1, 1))]
    for _ in range(2):
        jl.append(jrefine(jl[-1]))
        tl.append(refine(tl[-1]))
    jps = jbuild_patchset(JHierarchy(jl))
    tps = build_patchset(Hierarchy(tl))
    coords_p = jst.to_patch(jps.fine, jnp.asarray(jl[-1].coords.T))
    fn = lambda x: deformation_corner_mats(x, 1.0, 2.0, 0.5)  # noqa: E731
    W_sym = np.asarray(jst.assemble_w(jps, jps.k, coords_p, fn, sym=True), np.float32)
    return jps, tps, W_sym


def _stencil(ps):
    return tuple(tuple(int(v) for v in o) for o in ps.stencil)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_k1_twin_matches_interpret_pallas_sym(problem):
    jps, tps, W = problem
    x = np.random.default_rng(1).normal(size=(3,) + tps.fine.lat_shape + (tps.P,)).astype(np.float32)
    y_pal = pst._apply_w_pallas_3d_sym.__wrapped__(
        _stencil(jps), tuple(jst.half_slots(jps)), 4, jnp.asarray(W), jnp.asarray(x),
        interpret=True,
    )
    y_twin = sk._apply_w_sym(tps, torch.from_numpy(W), torch.from_numpy(x))
    assert y_twin.dtype == torch.float32
    # float32 summation order differs: ~1e-7 relative, limit 1e-5
    assert _rel(y_twin, y_pal) < 1e-5


def test_k2_twin_matches_interpret_pallas_pencil_bf16(problem):
    jps, tps, W = problem
    x = np.random.default_rng(2).normal(size=(3,) + tps.fine.lat_shape + (tps.P,)).astype(np.float32)
    Wpc_j = pst.to_pencil_major(jps, jnp.asarray(W), jnp.bfloat16)
    Wpc_t = sk.to_pencil_major(tps, torch.from_numpy(W), torch.bfloat16)
    # the same bf16 weights, bit for bit (expansion + round-to-nearest-even)
    np.testing.assert_array_equal(
        Wpc_t.view(torch.int16).numpy(), np.asarray(Wpc_j).view(np.int16)
    )
    y_pal = pst._apply_w_pallas_3d_pc.__wrapped__(
        _stencil(jps), Wpc_j, jnp.asarray(x), interpret=True
    )
    y_twin = sk._apply_w_pencil(tps, Wpc_t, torch.from_numpy(x))
    assert _rel(y_twin, y_pal) < 1e-5
    # the wrapper on CPU tensors is the twin, bit for bit, and counts nothing
    sk.reset_launches()
    assert torch.equal(sk.apply_w_pencil(tps, Wpc_t, torch.from_numpy(x)), y_twin)
    assert torch.equal(st.apply_w(tps, st.PencilW(Wpc_t), torch.from_numpy(x)), y_twin)
    assert sk.launches == {"apply_w_sym": 0, "apply_w_pencil": 0, "apply_w_df_sym": 0}


def test_k4_twin_matches_interpret_pallas_df_and_f64(problem):
    jps, tps, W = problem
    x64 = np.random.default_rng(3).normal(size=(3,) + tps.fine.lat_shape + (tps.P,))
    xh = x64.astype(np.float32)
    xl = (x64 - xh.astype(np.float64)).astype(np.float32)
    yh, yl = pst._apply_w_df_pallas_3d_sym.__wrapped__(
        _stencil(jps), tuple(jst.half_slots(jps)), 4, jnp.asarray(W),
        jnp.asarray(xh), jnp.asarray(xl), interpret=True,
    )
    y_pal = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    th, tl = sk.apply_w_df_sym(tps, torch.from_numpy(W), torch.from_numpy(xh), torch.from_numpy(xl))
    assert th.dtype == tl.dtype == torch.float32
    y_twin = th.double() + tl.double()
    W64 = torch.from_numpy(W).double()
    y_ref = sk._apply_w_sym(tps, W64, torch.from_numpy(xh).double() + torch.from_numpy(xl).double())
    x_abs = (torch.from_numpy(xh).double() + torch.from_numpy(xl).double()).abs()
    scale = float(sk._apply_w_sym(tps, W64.abs(), x_abs).max())  # max sum |W||x|
    # interpret mode cannot keep the EFT compensation (XLA folds it), so
    # the Pallas result is float32-grade; the twin keeps it.  Its lo part
    # sums ~45 terms in float32, each rounding at ~eps32^2 of |y|
    # (measured 5.3e-14 here), hence 1e-13 of sum |W||x|
    assert _rel(y_twin, y_pal) < 1e-5
    assert float((y_twin - y_ref).abs().max()) / scale < 1e-13
    # the pair is renormalized: |lo| <= ulp(hi) / 2
    assert bool((tl.abs() <= torch.finfo(torch.float32).eps * th.abs()).all())


def test_k4_twin_df_matches_jax_df_form(problem):
    """The port's EFT form against the JAX package's _apply_w_df_full on
    the expanded W: the same arithmetic in the same order, so equal."""
    jps, tps, W = problem
    rng = np.random.default_rng(4)
    xh = rng.normal(size=(3,) + tps.fine.lat_shape + (tps.P,)).astype(np.float32)
    xl = (rng.normal(size=xh.shape) * 1e-8).astype(np.float32)
    Wf_j = jst.expand_sym_w(jps, jnp.asarray(W))
    jh, jl = jst._apply_w_df_full(jps, Wf_j, jnp.asarray(xh), jnp.asarray(xl))
    Wf_t = st.expand_sym_w(tps, torch.from_numpy(W))
    np.testing.assert_array_equal(Wf_t.numpy(), np.asarray(Wf_j))
    th, tl = sk._apply_w_df_full(tps, Wf_t, torch.from_numpy(xh), torch.from_numpy(xl))
    y_j = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    y_t = th.double().numpy() + tl.double().numpy()
    assert np.abs(y_t - y_j).max() / np.abs(y_j).max() < 1e-14


def test_slot_table_codes(problem):
    _, tps, _ = problem
    stencil = _stencil(tps)
    kept = tuple(st.half_slots(tps))
    tab = sk._slot_table(stencil, kept, torch.device("cpu")).numpy()
    assert tab.shape == (15, 4)
    for oi, (o0, o1, o2, code) in enumerate(tab):
        assert (o0, o1, o2) == stencil[oi]
        if oi in kept:
            assert code == kept.index(oi)
        else:  # transpose of the stored slot at the opposite offset
            assert stencil[kept[-1 - code]] == tuple(-v for v in stencil[oi])


def test_wrappers_raise_off_cpu_and_cuda(problem):
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device raises instead of taking the twin."""
    _, tps, W = problem
    Wm = torch.from_numpy(W).to("meta")
    xm = torch.empty((3,) + tps.fine.lat_shape + (tps.P,), device="meta")
    with pytest.raises(ValueError):
        sk.apply_w_sym(tps, Wm, xm)
    with pytest.raises(ValueError):
        sk.apply_w_df_sym(tps, Wm, xm, xm)
    with pytest.raises(ValueError):
        sk.apply_w_pencil(tps, torch.empty((1,), device="meta"), xm)
    with pytest.raises(NotImplementedError):
        st.apply_w(tps, st.expand_sym_w(tps, Wm), xm)


def test_build_requires_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; it never falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
