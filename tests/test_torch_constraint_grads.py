"""The ADMM x-update's constraint gradients (stencil_kernels
.constraint_grads, PatchOps.constraint_grads): the additive B = dg/du
(4, 3, n0, n1, n2, P) of the volume and barycenter constraints, from KC
(csrc/stencil.cu, part 5) for a 3D CUDA field and from
patchdeform.constraint_grads_analytic_p otherwise.

On the CPU: the plain form and its dispatch (no launch, cgrads_path
"plain"), KC's table, and its gather written out site by site in float64
as the kernel computes it (per class t and corner a the cell whose corner
a is the site, its state from the 4 corners, its 12 values at corner a)
against the plain form, with pvalid off and on.  On the card (marker
``card``, skipped without one): the kernel against its twin at 9^3 x 224
and 3^3 x 5, with and without pvalid, bit for bit from call to call,
PatchOps.constraint_grads on it, its launch count, the plain form for a 2D
lattice and an error for what it does not take.  The file imports neither
JAX nor the JAX package; on a machine without JAX run it without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_constraint_grads.py
"""
import pytest
import torch

from admm_optim_tpu_torch import admm_run, xupdate_solve
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset
from admm_optim_tpu_torch.ops import patchdeform as pdfm
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import stencil_kernels as sk

torch.set_num_threads(1)

LIMIT = 1e-5  # max abs over max |B|: float32 sums of the same cell values in another order


def _inputs(ctx, seed, P=None):
    """coords_p, u (x 0.05, free-masked) and a pvalid with zeros, from one
    generator; the first P patches of each where P is given."""
    ops = admm_run.problem(ctx).ops
    g = torch.Generator(device=ctx.coords.device).manual_seed(seed)
    dev, dt = ctx.coords.device, ctx.coords.dtype
    cp = ops.coords_p
    u = torch.randn(cp.shape, generator=g, device=dev, dtype=dt) * 0.05 * ops.tab.free.to(dt)
    pvalid = (torch.arange(cp.shape[-1], device=dev) % 5 != 0).to(dt)
    if P is not None:
        cp, u, pvalid = cp[..., :P], u[..., :P], pvalid[:P]
    return cp.contiguous(), u.contiguous(), pvalid.contiguous()


def _plain(ps, cp, u, pvalid=None):
    return pdfm.constraint_grads_analytic_p(ps, pdfm.cell_geometry(ps, cp, pvalid), u, 0.0, None)


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


# ---------------------------------------------------------------------------
# the CPU: plain form, dispatch, the kernel's table and gather
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu1():
    return xupdate_solve.build(1, "cpu", torch.float64)


def _shift(f, o):
    return st.shift_read(f, [int(v) for v in o], lat_axes_offset=f.dim() - 4)


def _gather(ps, cp, u, pvalid):
    """B site by site as constraint_grads_kernel computes it: per (class t,
    corner a) the cell whose corner a is the site, its geometry, A, cof(A),
    det(A) and centroid from its 4 corners, and its values at corner a,
    vol C g_a and vol (cent_j C g_a + e_j det(A) / 4); then pvalid times
    the sums."""
    co = torch.tensor(list(sk.stencil_tables(ps).packed("classes"))).reshape(6, 4, 3)
    lat = cp.shape[1:4]
    site = torch.stack(torch.meshgrid(*[torch.arange(n) for n in lat], indexing="ij"))
    cells = torch.tensor(lat).reshape(3, 1, 1, 1) - 1
    eye = torch.eye(3, dtype=cp.dtype)
    B = cp.new_zeros((4, 3) + tuple(cp.shape[1:]))
    for t in range(6):
        for a in range(4):
            anchor = site - co[t, a].reshape(3, 1, 1, 1)
            inside = ((anchor >= 0) & (anchor < cells)).all(0)[..., None].to(cp.dtype)
            x = [_shift(cp, co[t, q] - co[t, a]) for q in range(4)]
            uu = [_shift(u, co[t, q] - co[t, a]) for q in range(4)]
            J = torch.stack([torch.stack([x[e + 1][c] - x[0][c] for e in range(3)]) for c in range(3)])
            # (*lat, P, 3, 3); the identity where the cell lies outside the lattice
            J = torch.where(inside[..., None, None] > 0, J.permute(2, 3, 4, 5, 0, 1), eye)
            vol = torch.linalg.det(J).abs() / 6 * inside
            Jinv = torch.linalg.inv(J)
            g = [-Jinv.sum(-2)] + [Jinv[..., e, :] for e in range(3)]  # (*lat, P, 3) each
            A = eye + sum(uu[q].permute(1, 2, 3, 4, 0)[..., :, None] * g[q][..., None, :] for q in range(4))
            det = torch.linalg.det(A)
            C = det[..., None, None] * torch.linalg.inv(A).transpose(-1, -2)
            cga = (C @ g[a][..., None])[..., 0].permute(4, 0, 1, 2, 3)  # (3, *lat, P)
            B[0] += vol * cga
            for j in range(3):
                cent = sum(x[q][j] + uu[q][j] for q in range(4)) / 4
                B[1 + j] += vol * (cent * cga + eye[j].reshape(3, 1, 1, 1, 1) * det / 4)
    return B * pvalid


@pytest.mark.parametrize("masked", [False, True], ids=["pvalid-off", "pvalid-on"])
def test_kernel_gather_matches_the_plain_form(cpu1, masked):
    """KC's gather, written out site by site in float64, equals the plain
    form (3^3 x 224), with and without padded patches."""
    cp, u, pvalid = _inputs(cpu1, seed=3)
    pv = pvalid if masked else None
    got = _gather(cpu1.ps, cp, u, torch.ones_like(pvalid) if pv is None else pv)
    assert _rel(got, _plain(cpu1.ps, cp, u, pv)) <= 1e-13


def test_classes_table(cpu1):
    """KC's table: the 6 x 4 x 3 class offsets that head the Hessian
    assembly's, each class's corners one Kuhn tetrahedron of the unit cube
    from (0, 0, 0) to (1, 1, 1)."""
    tabs = sk.stencil_tables(cpu1.ps)
    flat = list(tabs.packed("classes"))
    assert flat == tabs.hess_rows(True)[:72]
    co = torch.tensor(flat).reshape(6, 4, 3)
    assert bool((co[:, 0] == 0).all()) and bool((co[:, 3] == 1).all())
    assert bool(((co[:, 1:] - co[:, :-1]).sum(-1) == 1).all())


def test_cpu_takes_the_plain_form(cpu1):
    """constraint_grads on CPU tensors: the plain form bit for bit, path
    "plain", no launch; PatchOps.constraint_grads is its consistent,
    free-masked form."""
    ops = admm_run.problem(cpu1).ops
    cp, u, _ = _inputs(cpu1, seed=5)
    sk.reset_launches()
    got = sk.constraint_grads(cpu1.ps, ops.geo, cp, u)
    assert torch.equal(got, _plain(cpu1.ps, cp, u))
    assert ops.cgrads_path(u) == "plain" and sk.launches["constraint_grads"] == 0 and not sk.launches_by_lattice
    assert torch.equal(ops.constraint_grads(u, 0.0, None), ops._cons(got))


def _inputs_2d(device):
    """A 2D channel patchset (refs=1), its cell geometry, coordinates and a
    random u, float32 on device."""
    levels = [geomgen.channel_2d(diag="fixed")]
    levels.append(refine(levels[0]))
    ps = build_patchset(Hierarchy(levels))
    cp = st.to_patch(ps.fine, torch.as_tensor(levels[-1].coords).T).to(device=device, dtype=torch.float32)
    u = (torch.randn(cp.shape, generator=torch.Generator().manual_seed(4)) * 0.05).to(device)
    return ps, pdfm.cell_geometry(ps, cp), cp, u


def test_2d_takes_the_plain_form_on_the_cpu():
    ps, geo, cp, u = _inputs_2d("cpu")
    sk.reset_launches()
    got = sk.constraint_grads(ps, geo, cp, u)
    assert sk.kernel_path(ps, u) == "plain" and sk.launches["constraint_grads"] == 0
    assert torch.equal(got, pdfm.constraint_grads_analytic_p(ps, geo, u, 0.0, None))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return {refs: xupdate_solve.build(refs, "cuda", torch.float32) for refs in (1, 3)}


def _kc(ps, cp, u, pvalid=None):
    return sk.constraint_grads(ps, pdfm.cell_geometry(ps, cp, pvalid), cp, u, pvalid)


@pytest.mark.card
@pytest.mark.parametrize("refs, P", [(3, None), (1, 5)], ids=["9^3x224", "3^3x5"])
def test_kernel_matches_twin(card, refs, P):
    ctx = card[refs]
    cp, u, pvalid = _inputs(ctx, seed=refs, P=P)
    for pv in (pvalid, None):
        got = _kc(ctx.ps, cp, u, pv)
        want = _plain(ctx.ps, cp, u, pv)
        assert got.shape == want.shape == (4,) + tuple(u.shape) and bool(torch.isfinite(got).all())
        assert _rel(got, want) <= LIMIT


@pytest.mark.card
def test_two_calls_same_bits(card):
    ctx = card[3]
    cp, u, pvalid = _inputs(ctx, seed=7)
    assert torch.equal(_kc(ctx.ps, cp, u, pvalid), _kc(ctx.ps, cp, u, pvalid))


@pytest.mark.card
def test_patch_ops_take_the_kernel(card):
    """PatchOps.constraint_grads on a CUDA field: path "kernel", one
    launch, the consistent free-masked form of the plain B."""
    ctx = card[3]
    ops = admm_run.problem(ctx).ops
    _, u, _ = _inputs(ctx, seed=9)
    sk.reset_launches()
    got = ops.constraint_grads(u, 0.0, None)
    assert ops.cgrads_path(u) == "kernel" and sk.launches["constraint_grads"] == 1
    assert _rel(got, ops._cons(_plain(ctx.ps, ops.coords_p, u))) <= LIMIT


@pytest.mark.card
def test_one_launch_a_call(card):
    ctx = card[1]
    cp, u, pvalid = _inputs(ctx, seed=11)
    geo = pdfm.cell_geometry(ctx.ps, cp, pvalid)
    sk.reset_launches()
    for n in (1, 2, 3):
        sk.constraint_grads(ctx.ps, geo, cp, u, pvalid)
        assert sk.launches["constraint_grads"] == n
    lattice = ctx.ps.fine.lat_shape + (ctx.ps.P,)
    assert sk.launches_by_lattice == {("constraint_grads", lattice): 3}


@pytest.mark.card
def test_2d_takes_the_plain_form_on_the_card(card):
    ps, geo, cp, u = _inputs_2d("cuda")
    sk.reset_launches()
    got = sk.constraint_grads(ps, geo, cp, u)
    assert sk.kernel_path(ps, u) == "plain" and sk.launches["constraint_grads"] == 0
    assert torch.equal(got, pdfm.constraint_grads_analytic_p(ps, geo, u, 0.0, None))


@pytest.mark.card
def test_refuses_what_it_does_not_take(card):
    """A 3D CUDA field takes the kernel or raises: float64, a pvalid of
    the wrong length or a non-contiguous u is an error, not the plain
    form."""
    ctx = card[1]
    cp, u, pvalid = _inputs(ctx, seed=13)
    geo = pdfm.cell_geometry(ctx.ps, cp, pvalid)
    with pytest.raises(ValueError):
        sk.constraint_grads(ctx.ps, geo, cp.double(), u.double())
    with pytest.raises(ValueError):
        sk.constraint_grads(ctx.ps, geo, cp, u, pvalid[:-1].contiguous())
    with pytest.raises(ValueError):
        sk.constraint_grads(ctx.ps, geo, cp, u.transpose(-1, -2).contiguous().transpose(-1, -2), pvalid)
