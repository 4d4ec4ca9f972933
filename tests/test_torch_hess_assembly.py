"""The ADMM x-update's Hessian stencil assembly (stencil_kernels
.assemble_hess, PatchOps.hess_fn): W_H = W_A + pvalid * sum_k Lambda_k
g_k'' in W_A's storage.

On the CPU: the plain form and its dispatch (no launch, the admm.hess
span's ``path`` "plain"), and the kernel's table and closed-form block
(eps_{cfj} (A (g_a x g_b))_j for patchdeform's S (dC/dA)[e_f (x) g_b] g_a)
gathered site by site as the kernel gathers them, against the plain form
in float64.  On the card (marker ``card``, skipped without one): the
kernel against its twin in half and full storage at 5^3 and 9^3 x 224,
bit for bit from call to call, hess_fn against A + the matvec-side HVP,
its launch count, the plain form for a 2D lattice and an error for what
it does not take.  The file imports neither JAX nor the JAX package; on a
machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hess_assembly.py
"""
import dataclasses

import pytest
import torch

from admm_optim_tpu_torch import admm_run, xupdate_solve
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.utils import profiling

torch.set_num_threads(1)

LIMIT = 1e-5  # max abs over max |W_H|: float32 sums of the same blocks in another form


def _inputs(ctx, seed, sym=True):
    """W_A (half, or expanded to full), coords_p, u (x 0.05, free-masked),
    Lambda, free and a pvalid with zeros, from one generator."""
    ps = ctx.ps
    ops = admm_run.problem(ctx).ops
    g = torch.Generator(device=ctx.coords.device).manual_seed(seed)
    dev, dt = ctx.coords.device, ctx.coords.dtype
    W_A = ctx.data.W[ps.k]
    if not sym:
        W_A = st.expand_sym_w(ps, W_A).contiguous()
    free = ops.tab.free.to(dt)
    u = (torch.randn(ops.coords_p.shape, generator=g, device=dev, dtype=dt) * 0.05 * free).contiguous()
    lam = torch.randn(4, generator=g, device=dev, dtype=dt)
    pvalid = (torch.arange(ps.P, device=dev) % 5 != 0).to(dt)
    return W_A, ops.coords_p, u, lam, free, pvalid


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


# ---------------------------------------------------------------------------
# the CPU: plain form, dispatch, the kernel's table and block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu1():
    return xupdate_solve.build(1, "cpu", torch.float64)


def _shift(f, o):
    return st.shift_read(f, [int(v) for v in o], lat_axes_offset=f.dim() - 4)


def _gather(ps, W_A, cp, u, lam, free, pvalid):
    """W_H site by site as assemble_hess_kernel computes it: per (class t,
    corner a) the cell whose corner a is the site, its state, and each
    stored block (a, b) of the table added at the slot's position, times
    free at both corners; then W_A + pvalid * the sums."""
    tabs = sk.stencil_tables(ps)
    flat = tabs.hess_rows(W_A.shape[0] != len(ps.stencil))
    co = torch.tensor(flat[:72]).reshape(6, 4, 3)
    pos = torch.tensor(flat[72:]).reshape(6, 4, 4)
    lat = cp.shape[1:4]
    site = torch.stack(torch.meshgrid(*[torch.arange(n) for n in lat], indexing="ij"))
    cells = torch.tensor(lat).reshape(3, 1, 1, 1) - 1
    sums = torch.zeros_like(W_A)
    lf = lam[1:] / 4
    eps = torch.zeros(3, 3, 3, dtype=W_A.dtype)
    for c, f, j in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        eps[c, f, j], eps[f, c, j] = 1.0, -1.0
    for t in range(6):
        for a in range(4):
            anchor = site - co[t, a].reshape(3, 1, 1, 1)
            inside = ((anchor >= 0) & (anchor < cells)).all(0)[..., None].to(W_A.dtype)
            x = [_shift(cp, co[t, q] - co[t, a]) for q in range(4)]
            uu = [_shift(u, co[t, q] - co[t, a]) for q in range(4)]
            J = torch.stack([torch.stack([x[e + 1][c] - x[0][c] for e in range(3)]) for c in range(3)])
            # (*lat, P, 3, 3); the identity where the cell lies outside the lattice
            J = torch.where(inside[..., None, None] > 0, J.permute(2, 3, 4, 5, 0, 1), torch.eye(3, dtype=J.dtype))
            vol = torch.linalg.det(J).abs() / 6 * inside
            Jinv = torch.linalg.inv(J)
            g = [-Jinv.sum(-2)] + [Jinv[..., e, :] for e in range(3)]  # (*lat, P, 3) each
            A = torch.eye(3, dtype=J.dtype) + sum(uu[q].permute(1, 2, 3, 4, 0)[..., :, None] * g[q][..., None, :]
                                                    for q in range(4))
            C = torch.linalg.det(A)[..., None, None] * torch.linalg.inv(A).transpose(-1, -2)
            S = lam[0] + sum(lam[1 + c] * sum(x[q][c] + uu[q][c] for q in range(4)) / 4 for c in range(3))
            cga = (C @ g[a][..., None])[..., 0]
            for b in range(4):
                p = int(pos[t, a, b])
                if p < 0:
                    continue
                w = (A @ torch.linalg.cross(g[a], g[b])[..., None])[..., 0]
                cgb = (C @ g[b][..., None])[..., 0]
                blk = vol[..., None, None] * (S[..., None, None] * torch.einsum("cfj,...j->...cf", eps, w)
                                              + cga[..., :, None] * lf + lf[:, None] * cgb[..., None, :])
                m = free * _shift(free, co[t, b] - co[t, a])
                sums[p] += blk.permute(4, 5, 0, 1, 2, 3) * m
    return W_A + sums * pvalid


@pytest.mark.parametrize("sym", [True, False], ids=["half", "full"])
def test_kernel_table_and_block_match_the_plain_form(cpu1, sym):
    """The table the kernel takes and its closed-form blocks, gathered
    site by site, equal the plain assembly (float64, 3^3 x 224)."""
    W_A, cp, u, lam, free, pvalid = _inputs(cpu1, seed=3, sym=sym)
    want = sk.assemble_hess(cpu1.ps, W_A, cp, u, lam, free, pvalid)
    assert _rel(_gather(cpu1.ps, W_A, cp, u, lam, free, pvalid), want) <= 1e-13


@pytest.mark.parametrize("sym, stored", [(True, 60), (False, 96)], ids=["half", "full"])
def test_hess_table(cpu1, sym, stored):
    """6 classes x 4 corners; every diagonal pair at the centre slot
    (position 0) and no other; 10 of each class's 16 pairs stored in half
    storage, all 16 in full; the packed table is 72 offsets + 96
    positions."""
    flat = sk.stencil_tables(cpu1.ps).hess_rows(sym)
    pos = flat[72:]
    assert len(flat) == 168 and sum(p >= 0 for p in pos) == stored
    assert [i for i, p in enumerate(pos) if p == 0] == [16 * t + 5 * a for t in range(6) for a in range(4)]
    assert len(sk.stencil_tables(cpu1.ps).packed("hess/half" if sym else "hess/full")) == 168


def test_cpu_takes_the_plain_form(cpu1):
    """hess_fn on CPU tensors: the plain form, path "plain", no launch, and
    the assembled H x equals A x + the matvec-side HVP."""
    ops = admm_run.problem(cpu1).ops
    _, _, u, lam, _, _ = _inputs(cpu1, seed=5)
    x = xupdate_solve.random_rhs(cpu1, seed=2)
    sk.reset_launches()
    hess = ops.hess_fn(u, lam, 0.0, None)
    assert hess.path == "plain" and sk.launches["assemble_hess"] == 0 and not sk.launches_by_lattice
    want = ops.A(x) + ops.hvp_fn(u, lam, 0.0, None)(x)
    assert float((hess(x) - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_admm_hess_span_says_plain():
    """Every admm.hess span of a traced CPU Newton loop carries path
    "plain"; untraced nothing records."""
    ctx = xupdate_solve.build(0, "cpu", torch.float64)
    cfg = dataclasses.replace(admm_run.BENCH_CFG, admm_steps=1, ns_max_its=1)
    profiling.reset_spans()
    admm_run.run(ctx, cfg)
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = admm_run.run(ctx, cfg)
    paths = [r["attrs"]["path"] for r in profiling.spans() if r["name"] == "admm.hess"]
    profiling.reset_spans()
    assert paths == ["plain"] * out.state.total_newton and paths


def _inputs_2d(device):
    """A 2D channel patchset (refs=1) and random W_A (half storage), its
    coordinates, u, Lambda (3,) and free, float32 on device."""
    levels = [geomgen.channel_2d(diag="fixed")]
    levels.append(refine(levels[0]))
    ps = build_patchset(Hierarchy(levels))
    g = torch.Generator().manual_seed(4)
    lat = ps.fine.lat_shape + (ps.P,)
    W_A = torch.randn((len(st.half_slots(ps)), 2, 2) + lat, generator=g)
    cp = st.to_patch(ps.fine, torch.as_tensor(levels[-1].coords).T)
    u = torch.randn(cp.shape, generator=g) * 0.05
    lam = torch.randn(3, generator=g)
    free = torch.as_tensor(ps.fine.free)
    return ps, [t.to(device=device, dtype=torch.float32) for t in (W_A, cp, u, lam, free)]


def test_2d_takes_the_plain_form_on_the_cpu():
    ps, args = _inputs_2d("cpu")
    sk.reset_launches()
    got = sk.assemble_hess(ps, *args)
    assert sk.kernel_path(ps, args[2]) == "plain" and sk.launches["assemble_hess"] == 0
    assert torch.equal(got, sk._assemble_hess(ps, *args))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return {refs: xupdate_solve.build(refs, "cuda", torch.float32) for refs in (2, 3)}


@pytest.mark.card
@pytest.mark.parametrize("refs", [2, 3], ids=["5^3x224", "9^3x224"])
@pytest.mark.parametrize("sym", [True, False], ids=["half", "full"])
def test_kernel_matches_twin(card, refs, sym):
    ctx = card[refs]
    args = _inputs(ctx, seed=refs, sym=sym)
    got = sk.assemble_hess(ctx.ps, *args)
    torch.cuda.synchronize()
    want = sk._assemble_hess(ctx.ps, *args)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= LIMIT
    # and without pvalid
    assert _rel(sk.assemble_hess(ctx.ps, *args[:-1]), sk._assemble_hess(ctx.ps, *args[:-1])) <= LIMIT


@pytest.mark.card
@pytest.mark.parametrize("sym", [True, False], ids=["half", "full"])
def test_two_calls_same_bits(card, sym):
    ctx = card[3]
    args = _inputs(ctx, seed=7, sym=sym)
    assert torch.equal(sk.assemble_hess(ctx.ps, *args), sk.assemble_hess(ctx.ps, *args))


@pytest.mark.card
def test_hess_fn_matches_operator_plus_hvp(card):
    ctx = card[3]
    ops = admm_run.problem(ctx).ops
    _, _, u, lam, _, _ = _inputs(ctx, seed=9)
    x = xupdate_solve.random_rhs(ctx, seed=1)
    hess = ops.hess_fn(u, lam, 0.0, None)
    want = ops.A(x) + ops.hvp_fn(u, lam, 0.0, None)(x)
    assert hess.path == "kernel"
    assert _rel(hess(x), want) <= LIMIT
    xb = torch.stack([x, -x])
    assert _rel(hess(xb), torch.stack([want, -want])) <= LIMIT


@pytest.mark.card
def test_one_launch_a_call(card):
    ctx = card[2]
    args = _inputs(ctx, seed=11)
    sk.reset_launches()
    for n in (1, 2, 3):
        sk.assemble_hess(ctx.ps, *args)
        assert sk.launches["assemble_hess"] == n
    lattice = ctx.ps.fine.lat_shape + (ctx.ps.P,)
    assert sk.launches_by_lattice == {("assemble_hess", lattice): 3}


@pytest.mark.card
def test_2d_takes_the_plain_form_on_the_card(card):
    ps, args = _inputs_2d("cuda")
    sk.reset_launches()
    got = sk.assemble_hess(ps, *args)
    assert sk.kernel_path(ps, args[2]) == "plain" and sk.launches["assemble_hess"] == 0
    assert torch.equal(got, sk._assemble_hess(ps, *args))


@pytest.mark.card
def test_refuses_what_it_does_not_take(card):
    """A 3D CUDA field takes the kernel or raises: float64, a wrong
    Lambda or a non-contiguous u is an error, not the plain form."""
    ctx = card[2]
    W_A, cp, u, lam, free, pvalid = _inputs(ctx, seed=13)
    with pytest.raises(ValueError):
        sk.assemble_hess(ctx.ps, W_A.double(), cp.double(), u.double(), lam.double(), free.double())
    with pytest.raises(ValueError):
        sk.assemble_hess(ctx.ps, W_A, cp, u, lam[:3], free, pvalid)
    with pytest.raises(ValueError):
        sk.assemble_hess(ctx.ps, W_A, cp, u.transpose(-1, -2).contiguous().transpose(-1, -2), lam, free)
