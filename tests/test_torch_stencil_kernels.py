"""Plain twins of the four ported stencil kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_patches.py runs them, plus the wrappers' dispatch rules.

The CUDA kernels themselves run only on the GPU; chip_smoke.py holds each
of them against these twins there."""
import numpy as np
import pytest
import torch

import jax
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
    assert set(sk.launches) == {
        "apply_w_sym", "apply_w_sym/lanes", "apply_w_pencil", "apply_w_pencil_batched", "apply_w_df_sym",
        "apply_w_full", "apply_w_full_t", "apply_w_full/c1", "apply_w_full_t/c1", "assemble_hess",
        "constraint_grads",
    }
    assert sum(sk.launches.values()) == 0


@pytest.mark.parametrize("lanes", [5, 1])
def test_k3_twin_matches_interpret_pallas_pencil_batched(problem, lanes):
    """K3's twin against jax.vmap of the JAX package's pencil apply, which
    its custom_vmap turns into _apply_w_pallas_3d_pc_batched (interpret
    mode here), with the same bf16 weights on both sides."""
    jps, tps, W = problem
    xb = np.random.default_rng(5).normal(size=(lanes, 3) + tps.fine.lat_shape + (tps.P,)).astype(np.float32)
    Wpc_j = pst.to_pencil_major(jps, jnp.asarray(W), jnp.bfloat16)
    Wpc_t = sk.to_pencil_major(tps, torch.from_numpy(W), torch.bfloat16)
    y_pal = jax.vmap(lambda x: jst.apply_w(jps, jst.PencilW(Wpc_j), x))(jnp.asarray(xb))
    y_twin = sk._apply_w_pencil_batched(tps, Wpc_t, torch.from_numpy(xb))
    assert y_twin.shape == xb.shape and y_twin.dtype == torch.float32
    # float32 summation order differs: ~1e-7 relative, limit 1e-5
    assert _rel(y_twin, y_pal) < 1e-5
    # each lane is K2's twin on that lane
    for b in range(lanes):
        assert torch.equal(y_twin[b], sk._apply_w_pencil(tps, Wpc_t, torch.from_numpy(xb[b])))
    # the wrapper and the dispatching apply_w take the twin on CPU tensors
    # and count no launch
    sk.reset_launches()
    assert torch.equal(sk.apply_w_pencil_batched(tps, Wpc_t, torch.from_numpy(xb)), y_twin)
    assert torch.equal(st.apply_w(tps, st.PencilW(Wpc_t), torch.from_numpy(xb)), y_twin)
    assert sum(sk.launches.values()) == 0


def test_k1_lane_form_is_the_per_lane_twin(problem):
    """K1 on a lane axis (B, C, n0, n1, n2, P): on CPU tensors the twin of
    each lane, as jax.vmap of the JAX package's symmetric apply gives."""
    jps, tps, W = problem
    xb = np.random.default_rng(6).normal(size=(5, 3) + tps.fine.lat_shape + (tps.P,)).astype(np.float32)
    y_j = jax.vmap(lambda x: jst._apply_w_sym(jps, jnp.asarray(W), x))(jnp.asarray(xb))
    sk.reset_launches()
    y = st.apply_w(tps, torch.from_numpy(W), torch.from_numpy(xb))
    assert y.shape == xb.shape and _rel(y, y_j) < 1e-5
    for b in range(5):
        assert torch.equal(y[b], sk._apply_w_sym(tps, torch.from_numpy(W), torch.from_numpy(xb[b])))
    assert sum(sk.launches.values()) == 0


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
    tab = np.array(sk._slot_rows(stencil, kept))
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
    xbm = torch.empty((5,) + tuple(xm.shape), device="meta")
    Wpc = torch.empty((1,), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        sk.apply_w_sym(tps, Wm, xm)
    with pytest.raises(ValueError):
        sk.apply_w_sym(tps, Wm, xbm)
    with pytest.raises(ValueError):
        sk.apply_w_df_sym(tps, Wm, xm, xm)
    with pytest.raises(ValueError):
        sk.apply_w_pencil(tps, Wpc, xm)
    with pytest.raises(ValueError):
        sk.apply_w_pencil_batched(tps, Wpc, xbm)
    with pytest.raises(ValueError):
        st.apply_w(tps, st.PencilW(Wpc), xbm)
    Wfm = st.expand_sym_w(tps, Wm)
    with pytest.raises(ValueError):
        sk.apply_w_full(tps, Wfm, xm)
    with pytest.raises(ValueError):
        sk.apply_w_full_t(tps, Wfm, xm)
    with pytest.raises(ValueError):
        st.apply_w(tps, Wfm, xm)


def test_2d_lattices_take_the_plain_forms_on_every_device():
    """The JAX package has no 2D kernel (pallas_stencil.py:29-34): a 2D
    apply on a non-CPU tensor returns the plain form's result instead of
    reaching a 3D-only kernel wrapper, for symmetric half and full W."""
    l0 = geomgen.channel_2d(n_side=(3, 1), diag="fixed")
    ps2 = build_patchset(Hierarchy([l0, refine(l0)]))
    lat, P = ps2.fine.lat_shape, ps2.P
    H, O = len(st.half_slots(ps2)), len(ps2.stencil)
    for lanes in ((), (5,)):
        xm = torch.empty(lanes + (2,) + lat + (P,), device="meta")
        for slots in (H, O):
            y = st.apply_w(ps2, torch.empty((slots, 2, 2) + lat + (P,), device="meta"), xm)
            assert y.device.type == "meta" and y.shape == xm.shape
    xm = torch.empty((2,) + lat + (P,), device="meta")
    yh, yl = st.apply_w_df(ps2, torch.empty((H, 2, 2) + lat + (P,), device="meta"), xm, xm)
    assert yh.shape == yl.shape == xm.shape
    # on the CPU the 2D dispatch is the plain twin itself
    rng = np.random.default_rng(8)
    W2 = torch.from_numpy(rng.normal(size=(H, 2, 2) + lat + (P,)))
    x2 = torch.from_numpy(rng.normal(size=(2,) + lat + (P,)))
    assert torch.equal(st.apply_w(ps2, W2, x2), sk._apply_w_sym(ps2, W2, x2))


def test_build_requires_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; it never falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


# ---------------------------------------------------------------------------
# K5 (full slot-major apply) and its transpose, float64
# ---------------------------------------------------------------------------

K5_SHAPES = [((3, 3, 3), 5), ((5, 5, 5), 7)]


def _k5_inputs(tps, shape, seed):
    lat, P = shape
    rng = np.random.default_rng(seed)
    O = len(tps.stencil)
    W = rng.normal(size=(O, 3, 3) + lat + (P,))
    x = rng.normal(size=(3,) + lat + (P,))
    y = rng.normal(size=(3,) + lat + (P,))
    return W, x, y


@pytest.mark.parametrize("shape", K5_SHAPES)
def test_k5_twin_matches_interpret_pallas_and_jax_apply(problem, shape):
    """K5's twin against the JAX package's full-stencil Pallas kernel in
    interpret mode and against its patchstencil.apply_w (the XLA form)."""
    jps, tps, _ = problem
    W, x, _ = _k5_inputs(tps, shape, 11)
    y_pal = pst._apply_w_pallas_3d.__wrapped__(
        _stencil(jps), pst._SLOT_CHUNK, jnp.asarray(W), jnp.asarray(x), interpret=True
    )
    y_jax = jst.apply_w(jps, jnp.asarray(W), jnp.asarray(x))
    y_twin = sk._apply_w_full(tps, torch.from_numpy(W), torch.from_numpy(x))
    assert y_twin.dtype == torch.float64
    assert _rel(y_twin, y_pal) < 1e-12
    assert _rel(y_twin, y_jax) < 1e-12
    # the wrapper, the dispatching apply_w and ApplyWFull on CPU tensors are
    # the twin, and count no launch
    sk.reset_launches()
    Wt, xt = torch.from_numpy(W), torch.from_numpy(x)
    assert torch.equal(sk.apply_w_full(tps, Wt, xt), y_twin)
    assert torch.equal(st.apply_w(tps, Wt, xt), y_twin)
    assert torch.equal(sk.ApplyWFull.apply(tps, Wt, xt), y_twin)
    assert sum(sk.launches.values()) == 0


@pytest.mark.parametrize("shape", K5_SHAPES)
def test_k5_transpose_twin_matches_jax_vjp_and_is_adjoint(problem, shape):
    jps, tps, _ = problem
    W, x, y = _k5_inputs(tps, shape, 12)
    _, vjp = jax.vjp(lambda v: jst.apply_w(jps, jnp.asarray(W), v), jnp.asarray(x))
    yt_jax = vjp(jnp.asarray(y))[0]
    Wt, xt, ytt = (torch.from_numpy(a) for a in (W, x, y))
    yt = sk._apply_w_full_t(tps, Wt, ytt)
    assert _rel(yt, yt_jax) < 1e-12
    assert torch.equal(sk.apply_w_full_t(tps, Wt, ytt), yt)
    # <A x, y> = <x, A^T y>
    a = float(torch.sum(sk._apply_w_full(tps, Wt, xt) * ytt))
    b = float(torch.sum(xt * yt))
    assert abs(a - b) <= 1e-13 * max(abs(a), abs(b))


def test_apply_w_full_autograd_backward_is_the_transpose(problem):
    """ApplyWFull's backward (and so apply_w's on full 3D W, which
    ns_solver.transpose_M records through the NS V-cycle) is K5^T's twin; a
    gradient with respect to W raises."""
    _, tps, _ = problem
    W, x, y = (torch.from_numpy(a) for a in _k5_inputs(tps, K5_SHAPES[0], 13))
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(st.apply_w(tps, W, xg), xg, y)
    assert torch.equal(g, sk._apply_w_full_t(tps, W, y))
    _, vjp = torch.func.vjp(lambda v: sk.ApplyWFull.apply(tps, W, v), x)
    assert torch.equal(vjp(y)[0], sk._apply_w_full_t(tps, W, y))
    Wg = W.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="differentiable in x only"):
        sk.ApplyWFull.apply(tps, Wg, x).sum().backward()


def test_transpose_table_codes(problem):
    _, tps, _ = problem
    stencil = _stencil(tps)
    tab = np.array(sk._transpose_rows(stencil))
    assert tab.shape == (15, 4)
    for q, (o0, o1, o2, code) in enumerate(tab):
        assert (o0, o1, o2) == tuple(-v for v in stencil[q]) and code == -1 - q
    direct = np.array(sk._slot_rows(stencil, tuple(range(15))))
    assert [tuple(r[:3]) for r in direct] == list(stencil)
    assert list(direct[:, 3]) == list(range(15))


# ---------------------------------------------------------------------------
# K5 and K5^T at C = 1 (the scalar pressure operators of the PCD Schur block)
# ---------------------------------------------------------------------------

def _k5_scalar_inputs(tps, shape, seed):
    lat, P = shape
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(len(tps.stencil), 1, 1) + lat + (P,))
    x = rng.normal(size=(1,) + lat + (P,))
    y = rng.normal(size=(1,) + lat + (P,))
    return W, x, y


@pytest.mark.parametrize("shape", K5_SHAPES)
def test_k5_scalar_twin_matches_interpret_pallas_and_jax_apply(problem, shape):
    """K5's twin at C = 1 against the JAX package's full-stencil Pallas
    kernel (generic in C) in interpret mode and against its XLA apply_w,
    dense random W and x so that every boundary pencil reads its lattice
    edge; float64, 1e-12.  The wrapper, apply_w and ApplyWFull on CPU
    tensors are the twin and count no launch."""
    jps, tps, _ = problem
    W, x, _ = _k5_scalar_inputs(tps, shape, 21)
    y_pal = pst._apply_w_pallas_3d.__wrapped__(
        _stencil(jps), pst._SLOT_CHUNK, jnp.asarray(W), jnp.asarray(x), interpret=True
    )
    y_jax = jst.apply_w(jps, jnp.asarray(W), jnp.asarray(x))
    Wt, xt = torch.from_numpy(W), torch.from_numpy(x)
    y_twin = sk._apply_w_full(tps, Wt, xt)
    assert y_twin.shape == x.shape and y_twin.dtype == torch.float64
    assert _rel(y_twin, y_pal) < 1e-12
    assert _rel(y_twin, y_jax) < 1e-12
    # boundary pencils on their own: the faces of the lattice
    for ax in range(3):
        for side in (0, -1):
            idx = [slice(None)] * 5
            idx[1 + ax] = side
            assert _rel(y_twin[tuple(idx)], np.asarray(y_pal)[tuple(idx)]) < 1e-12
    sk.reset_launches()
    assert torch.equal(sk.apply_w_full(tps, Wt, xt), y_twin)
    assert torch.equal(st.apply_w(tps, Wt, xt), y_twin)
    assert torch.equal(sk.ApplyWFull.apply(tps, Wt, xt), y_twin)
    assert sum(sk.launches.values()) == 0


@pytest.mark.parametrize("shape", K5_SHAPES)
def test_k5_scalar_transpose_twin_matches_jax_vjp_and_is_adjoint(problem, shape):
    """K5^T's twin at C = 1 against the jax.vjp of the JAX apply (1e-12),
    <A x, y> = <x, A^T y> (1e-13), and as the autograd backward of
    apply_w on a scalar field."""
    jps, tps, _ = problem
    W, x, y = _k5_scalar_inputs(tps, shape, 22)
    _, vjp = jax.vjp(lambda v: jst.apply_w(jps, jnp.asarray(W), v), jnp.asarray(x))
    Wt, xt, ytt = (torch.from_numpy(a) for a in (W, x, y))
    yt = sk._apply_w_full_t(tps, Wt, ytt)
    assert _rel(yt, vjp(jnp.asarray(y))[0]) < 1e-12
    assert torch.equal(sk.apply_w_full_t(tps, Wt, ytt), yt)
    a = float(torch.sum(sk._apply_w_full(tps, Wt, xt) * ytt))
    b = float(torch.sum(xt * yt))
    assert abs(a - b) <= 1e-13 * max(abs(a), abs(b))
    xg = xt.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(st.apply_w(tps, Wt, xg), xg, ytt)
    assert torch.equal(g, yt)


def test_component_counts_the_wrappers_take(problem):
    """On meta tensors (neither CPU nor CUDA): C = 1 and C = 3 pass the
    shape checks of the full-stencil apply and its transpose, through
    apply_w and ApplyWFull too, and are refused only for the device; C = 2
    is refused for its shape, and so is C = 1 on K1-K4, which the JAX
    package never sends a scalar field."""
    _, tps, _ = problem
    lat, P = tps.fine.lat_shape, tps.P
    O, H = len(tps.stencil), len(st.half_slots(tps))

    def field(C, lanes=()):
        return torch.empty(lanes + (C,) + lat + (P,), device="meta")

    def weights(slots, C):
        return torch.empty((slots, C, C) + lat + (P,), device="meta")

    for C in (1, 3):
        for fn in (sk.apply_w_full, sk.apply_w_full_t, st.apply_w, sk.ApplyWFull.apply):
            with pytest.raises(ValueError, match="must be on the CPU or a CUDA device"):
                fn(tps, weights(O, C), field(C))
    for fn in (sk.apply_w_full, sk.apply_w_full_t, st.apply_w):
        with pytest.raises(ValueError, match="C = 1 or 3"):
            fn(tps, weights(O, 2), field(2))
    Wpc = torch.empty((1,), dtype=torch.bfloat16, device="meta")
    scalar_calls = (
        lambda: sk.apply_w_sym(tps, weights(H, 1), field(1)),
        lambda: sk.apply_w_sym(tps, weights(H, 1), field(1, (5,))),
        lambda: st.apply_w(tps, weights(H, 1), field(1)),
        lambda: sk.apply_w_pencil(tps, Wpc, field(1)),
        lambda: sk.apply_w_pencil_batched(tps, Wpc, field(1, (5,))),
        lambda: sk.apply_w_df_sym(tps, weights(H, 1), field(1), field(1)),
    )
    for call in scalar_calls:
        with pytest.raises(ValueError, match="C = 3, got .*scalar fields only to the full-stencil apply"):
            call()


# ---------------------------------------------------------------------------
# the scalar kernel and K1's lane kernel: by-value tables, refusals, the
# twins at a P that is no multiple of 4, and the W entries no apply reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sym", "full", "full_t"])
def test_by_value_tables_equal_the_device_tables(problem, kind):
    """The 15 x 4 C ints packed for the kernels, which all take their slot
    table by value, equal row for row the rows made from the JAX package's
    stencil and half slots (_slot_rows, _transpose_rows), and are made once
    per patchset."""
    jps, tps, _ = problem
    stencil = _stencil(jps)
    assert _stencil(tps) == stencil and len(stencil) == sk.BY_VALUE_SLOTS == 15
    jkept = tuple(int(h) for h in jst.half_slots(jps))
    tabs = sk.stencil_tables(tps)
    assert sk.stencil_tables(tps) is tabs and tabs.stencil == stencil
    assert tabs.kept == jkept and tabs.n_slots == 15
    if kind == "full_t":
        want = sk._transpose_rows(stencil)
    else:
        want = sk._slot_rows(stencil, jkept if kind == "sym" else tuple(range(15)))
    packed = tabs.packed(kind)
    assert tabs.packed(kind) is packed and len(packed) == 60
    np.testing.assert_array_equal(np.array(list(packed)).reshape(15, 4), np.array(want))
    assert tabs.rows(kind) == want


def test_by_value_table_refuses_another_slot_count():
    """A 2D patchset's 7-slot stencil does not fit the 15-slot by-value
    table (the kernels are 3D only; _check refuses 2D before)."""
    l0 = geomgen.channel_2d(n_side=(3, 1), diag="fixed")
    ps2 = build_patchset(Hierarchy([l0, refine(l0)]))
    with pytest.raises(ValueError, match="by-value table holds 15 slots"):
        sk.stencil_tables(ps2).packed("full")


@pytest.mark.parametrize("case", ["no lanes", "nine lanes", "strided field", "strided W", "2^31 sites on lanes",
                                  "2^31 sites on a scalar field", "2^31 sites on the scalar transpose",
                                  "2^31 sites on one field of K1", "2^31 sites on K5 at C = 3",
                                  "2^31 sites on K5^T at C = 3", "2^31 sites on K2", "2^31 sites on K3",
                                  "2^31 sites on K4"])
def test_new_kernels_refusals_on_meta_tensors(problem, case):
    """What the wrappers of the kernels with a by-value table (K1 on lanes
    and on one field, the scalar kernel, K5 and K5^T at C = 3, K2, K3 and
    K4) refuse, on meta tensors (no memory behind them): a lane axis of 0 or 9
    lanes, a field or W that is not contiguous, and a lattice of 2^31 sites
    or more, which the kernels' 32-bit site indices cannot hold.  Each is
    refused for that reason, ahead of the refusal of the meta device."""
    _, tps, _ = problem
    lat, P = tps.fine.lat_shape, tps.P
    H, O = len(st.half_slots(tps)), len(tps.stencil)
    meta = dict(device="meta")
    big = (2, 1024, 1024, 1024)  # 2^31 sites
    if case == "no lanes":
        call = lambda: sk.apply_w_sym(tps, torch.empty((H, 3, 3) + lat + (P,), **meta),  # noqa: E731
                                      torch.empty((0, 3) + lat + (P,), **meta))
        match = "1 to 8 lanes, got 0"
    elif case == "nine lanes":
        call = lambda: sk.apply_w_sym(tps, torch.empty((H, 3, 3) + lat + (P,), **meta),  # noqa: E731
                                      torch.empty((9, 3) + lat + (P,), **meta))
        match = "1 to 8 lanes, got 9"
    elif case == "strided field":
        x = torch.empty((5, 3) + lat + (2 * P,), **meta)[..., ::2]
        call = lambda: sk.apply_w_sym(tps, torch.empty((H, 3, 3) + lat + (P,), **meta), x)  # noqa: E731
        match = "must be contiguous"
    elif case == "strided W":
        W = torch.empty((O, 1, 1) + lat + (2 * P,), **meta)[..., ::2]
        call = lambda: sk.apply_w_full(tps, W, torch.empty((1,) + lat + (P,), **meta))  # noqa: E731
        match = "must be contiguous"
    elif case == "2^31 sites on lanes":
        call = lambda: sk.apply_w_sym(tps, torch.empty((H, 3, 3) + big, **meta),  # noqa: E731
                                      torch.empty((2, 3) + big, **meta))
        match = "indexes lattice sites in 32 bits"
    elif case in ("2^31 sites on K2", "2^31 sites on K3"):
        W_pc = torch.empty((2, 1024, O, 3, 3, 1024, 1024), dtype=torch.bfloat16, **meta)
        if case.endswith("K2"):
            call = lambda: sk.apply_w_pencil(tps, W_pc, torch.empty((3,) + big, **meta))  # noqa: E731
        else:
            call = lambda: sk.apply_w_pencil_batched(tps, W_pc, torch.empty((2, 3) + big, **meta))  # noqa: E731
        match = "indexes lattice sites in 32 bits"
    elif case == "2^31 sites on K4":
        x = torch.empty((3,) + big, **meta)
        call = lambda: sk.apply_w_df_sym(tps, torch.empty((H, 3, 3) + big, **meta), x, x)  # noqa: E731
        match = "indexes lattice sites in 32 bits"
    elif case == "2^31 sites on one field of K1":
        call = lambda: sk.apply_w_sym(tps, torch.empty((H, 3, 3) + big, **meta),  # noqa: E731
                                      torch.empty((3,) + big, **meta))
        match = "indexes lattice sites in 32 bits"
    elif case.endswith("C = 3"):
        fn = sk.apply_w_full_t if "K5^T" in case else sk.apply_w_full
        call = lambda: fn(tps, torch.empty((O, 3, 3) + big, **meta), torch.empty((3,) + big, **meta))  # noqa: E731
        match = "indexes lattice sites in 32 bits"
    else:
        fn = sk.apply_w_full if case.endswith("field") else sk.apply_w_full_t
        call = lambda: fn(tps, torch.empty((O, 1, 1) + big, **meta), torch.empty((1,) + big, **meta))  # noqa: E731
        match = "indexes lattice sites in 32 bits"
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("kind", ["sym", "sym on one lane", "full", "full_t", "df"])
def test_c3_field_kernels_take_the_packed_table_of_their_kind(problem, monkeypatch, kind):
    """K1 on one field (or on a lane axis of one lane), K5 and K5^T at C = 3
    launch the C = 3 entry point with the packed by-value table of their
    kind, under their own launch counter names, and K4 its own entry point
    with K1's packed table and the lattice: recorded by a stand-in for the
    launch, on meta tensors, so no card is needed."""
    _, tps, _ = problem
    lat, P = tps.fine.lat_shape, tps.P
    H, O = len(st.half_slots(tps)), len(tps.stencil)
    calls = []
    monkeypatch.setattr(sk, "_launch", lambda name, fn, lattice, *args, device: calls.append(
        (name, fn, lattice, args, device)))
    x = torch.empty(((1,) if kind == "sym on one lane" else ()) + (3,) + lat + (P,), device="meta")
    W = torch.empty((H if kind in ("sym", "sym on one lane", "df") else O, 3, 3) + lat + (P,), device="meta")
    if kind == "df":
        xl = torch.empty_like(x)
        yh, yl = sk.apply_w_df_sym(tps, W, x, xl)
        assert yh.shape == yl.shape == x.shape and yh.device == yl.device == x.device
        ((got_name, entry, lattice, args, device),) = calls
        assert (got_name, entry, device) == ("apply_w_df_sym", "apply_w_df_sym_f32", x.device)
        assert lattice == tuple(lat) + (P,)
        assert args[5] is sk.stencil_tables(tps).packed("sym")
        assert args[6:] == lattice
        return
    if kind.startswith("sym"):
        y = sk.apply_w_sym(tps, W, x)
        table, name = "sym", "apply_w_sym"
    else:
        fn = sk.apply_w_full if kind == "full" else sk.apply_w_full_t
        y = fn(tps, W, x)
        table, name = kind, fn.__name__
    assert y.shape == x.shape and y.device == x.device
    ((got_name, entry, lattice, args, device),) = calls
    assert (got_name, entry, device) == (name, "apply_w_c3_f32", x.device)
    assert lattice == tuple(lat) + (P,)
    assert args[3] is sk.stencil_tables(tps).packed(table)
    assert args[4:] == lattice


@pytest.mark.parametrize("lanes", [None, 5])
def test_pencil_kernels_take_the_packed_full_table(problem, monkeypatch, lanes):
    """K2 (a field) and K3 (a lane axis) launch the pencil entry point with
    the packed by-value table of K5's direct rows (the kernel reads their
    offsets), the lattice and the lane count, under their own launch
    counter names: recorded by a stand-in for the launch, on meta tensors,
    so no card is needed."""
    _, tps, _ = problem
    lat, P = tps.fine.lat_shape, tps.P
    calls = []
    monkeypatch.setattr(sk, "_launch", lambda name, fn, lattice, *args, device: calls.append(
        (name, fn, lattice, args, device)))
    W_pc = torch.empty(tuple(lat[:2]) + (len(tps.stencil), 3, 3, lat[2], P), dtype=torch.bfloat16, device="meta")
    x = torch.empty(((lanes,) if lanes else ()) + (3,) + lat + (P,), device="meta")
    fn = sk.apply_w_pencil_batched if lanes else sk.apply_w_pencil
    y = fn(tps, W_pc, x)
    assert y.shape == x.shape and y.device == x.device
    ((name, entry, lattice, args, device),) = calls
    assert (name, entry, device) == (fn.__name__, "apply_w_pencil_bf16", x.device)
    assert lattice == tuple(lat) + (P,)
    assert args[3] is sk.stencil_tables(tps).packed("full")
    assert args[4:] == lattice + (lanes or 1,)


def test_launch_counts_by_lattice_are_reset_with_the_counts(problem):
    """reset_launches clears the counts by kernel and lattice beside the
    counts by kernel, and a launch off a CUDA device is refused before it
    counts anywhere."""
    _, tps, _ = problem
    sk.launches["apply_w_full"] = 3
    sk.launches_by_lattice[("apply_w_full", (5, 5, 5, 224))] = 3
    sk.reset_launches()
    assert sum(sk.launches.values()) == 0 and sk.launches_by_lattice == {}
    with pytest.raises(ValueError, match="must be on the CPU or a CUDA device"):
        sk._launch("apply_w_full", "apply_w_c3_f32", (5, 5, 5, 224), device=torch.device("meta"))
    assert sum(sk.launches.values()) == 0 and sk.launches_by_lattice == {}


@pytest.mark.parametrize("lanes", [2, 5, 8])
def test_k1_lane_twin_is_the_single_field_twin_per_lane(problem, lanes):
    """The lane form on CPU tensors equals the single-field twin on each
    lane's field bit for bit (what chip_smoke.py holds the lane kernel to
    against K1 on the card), and jax.vmap of the JAX symmetric apply within
    1e-6 of max |y| in float32 (another summation order)."""
    jps, tps, W = problem
    xb = np.random.default_rng(30 + lanes).normal(size=(lanes, 3) + tps.fine.lat_shape + (tps.P,)).astype(np.float32)
    Wt = torch.from_numpy(W)
    y = sk.apply_w_sym(tps, Wt, torch.from_numpy(xb))
    assert y.shape == xb.shape and y.dtype == torch.float32
    for b in range(lanes):
        assert torch.equal(y[b], sk._apply_w_sym(tps, Wt, torch.from_numpy(xb[b])))
    y_j = jax.vmap(lambda x: jst._apply_w_sym(jps, jnp.asarray(W), x))(jnp.asarray(xb))
    assert _rel(y, y_j) < 1e-6


ODD_P_SHAPE = ((5, 5, 5), 6)  # P % 4 != 0: the scalar kernel's scalar-width form


@pytest.mark.parametrize("transposed", [False, True])
def test_k5_scalar_twins_float32_at_a_p_that_is_no_multiple_of_4(problem, transposed):
    """The scalar twins in float32 at P = 6 against the JAX package: K5's
    against the full-stencil Pallas kernel in interpret mode, K5^T's against
    the jax.vjp of the JAX apply; within 1e-6 of max |y| (15 float32
    products summed in another order)."""
    jps, tps, _ = problem
    W, x, y = (a.astype(np.float32) for a in _k5_scalar_inputs(tps, ODD_P_SHAPE, 31))
    Wt = torch.from_numpy(W)
    if transposed:
        _, vjp = jax.vjp(lambda v: jst.apply_w(jps, jnp.asarray(W), v), jnp.asarray(x))
        got, want = sk.apply_w_full_t(tps, Wt, torch.from_numpy(y)), vjp(jnp.asarray(y))[0]
    else:
        want = pst._apply_w_pallas_3d.__wrapped__(
            _stencil(jps), pst._SLOT_CHUNK, jnp.asarray(W), jnp.asarray(x), interpret=True
        )
        got = sk.apply_w_full(tps, Wt, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("form", ["scalar K5", "scalar K5^T", "K5", "K5^T", "K1", "K1 on lanes", "K2", "K3"])
def test_w_entries_beyond_the_lattice_edge_are_never_used(problem, form):
    """Every W entry whose neighbour lies outside the lattice filled with
    1e30: no twin's result changes by a bit.  K2 and K3 take it as the
    bf16 pencil-major form of the expanded W.  The kernels clamp the
    addresses of such neighbours to the site and drop the weight;
    chip_smoke.py holds them to the same on the card."""
    _, tps, W_sym = problem
    lat, P = (5, 5, 5), 6
    rng = np.random.default_rng(32)
    if form in ("K2", "K3"):
        W = st.expand_sym_w(tps, torch.from_numpy(W_sym))
        lanes = (5,) if form == "K3" else ()
        x = torch.from_numpy(rng.normal(size=lanes + (3,) + tps.fine.lat_shape + (tps.P,)).astype(np.float32))
        apply = sk.apply_w_pencil_batched if lanes else sk.apply_w_pencil
        fn = lambda ps, W, x: apply(ps, sk.to_pencil_major(ps, W, torch.bfloat16), x)  # noqa: E731
    elif form.startswith("K1"):
        W = torch.from_numpy(W_sym)
        lanes = (5,) if form.endswith("lanes") else ()
        x = torch.from_numpy(rng.normal(size=lanes + (3,) + tps.fine.lat_shape + (tps.P,)).astype(np.float32))
        fn = sk.apply_w_sym
    else:
        C = 1 if form.startswith("scalar") else 3
        W = torch.from_numpy(rng.normal(size=(len(tps.stencil), C, C) + lat + (P,)).astype(np.float32))
        x = torch.from_numpy(rng.normal(size=(C,) + lat + (P,)).astype(np.float32))
        fn = sk.apply_w_full_t if form.endswith("^T") else sk.apply_w_full
    Wp = sk.fill_unused_w(tps, W, 1e30)
    changed = int((Wp != W).sum())
    assert changed > 0 and float(Wp.max()) > 9e29
    # the center slot has no neighbour outside; an offset of +1 along one
    # axis loses that axis' last plane
    assert torch.equal(Wp[0], W[0])
    assert torch.equal(fn(tps, Wp, x), fn(tps, W, x))
